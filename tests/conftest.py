"""Test config: an 8-device virtual CPU mesh, set up before JAX starts.

Sharding/parallel tests exercise the multi-device code paths over a Mesh
without accelerators (SURVEY.md section 4).  Set BROTLI_TEST_PLATFORM
(e.g. `cuda`) to run on a GPU instead; tests that need the card take the
`gpu` fixture and are marked `gpu` (`pytest -m gpu`).

Inputs come from the seeded corpus (brotli_tpu/corpus.py), never from
files outside the repository.
"""

import os

os.environ["JAX_PLATFORMS"] = os.environ.get("BROTLI_TEST_PLATFORM", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pytest  # noqa: E402

from brotli_tpu import corpus  # noqa: E402

# Seeded stand-ins for the reference's fixtures: prose the size of
# alice29.txt, an HTML page, and a font-like binary.
TEXT = corpus.text(152_089, 0)
HTML = corpus.html(65_536, 1)
FONT = corpus.font(65_536, 2)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `BROTLI_TEST_PLATFORM=cuda "
                    "python -m pytest -m gpu tests/` on the card")
