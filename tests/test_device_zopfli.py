"""Device Zopfli DP decision-equality gate (VERDICT r2 item 7).

The device DP must reproduce the host q10 command stream exactly on
corpus prefixes: same commands (insert/copy/dist/prefix packings), same
trailing insert.  Float64 cost arithmetic in the host's association
order makes this bit-deterministic, not approximate.
"""

import pytest

from conftest import HTML, TEXT

SOURCES = {"text": TEXT, "html": HTML[1000:], "prose": TEXT[50000:]}


def _host_q10(data: bytes):
    from brotli_tpu.encode.api import _NO_MASK, _padded
    from brotli_tpu.encode.backward_refs_hq import (
        create_zopfli_backward_references,
    )
    from brotli_tpu.encode.hash_binary_tree import BinaryTreeHasher

    n = len(data)
    hasher = BinaryTreeHasher(22, n)
    cache = [4, 11, 15, 16]
    commands, _, last_insert = create_zopfli_backward_references(
        n, 0, _padded(bytes(data)), _NO_MASK, hasher, cache, 0,
    )
    return commands, last_insert


def _cmd_tuple(c):
    return (c.insert_len, c.copy_len, c.dist_extra, c.cmd_prefix,
            c.dist_prefix)


@pytest.mark.parametrize("name,cut", [
    ("text", 1200),
    pytest.param("html", 1000, marks=pytest.mark.slow),
    pytest.param("prose", 900, marks=pytest.mark.slow),
])
def test_device_dp_matches_host_q10(name, cut):
    from brotli_tpu.ops.device_zopfli import zopfli_commands_device

    data = SOURCES[name][:cut]
    host_cmds, host_li = _host_q10(data)
    dev_cmds, dev_li = zopfli_commands_device(data)
    assert dev_li == host_li
    assert [_cmd_tuple(c) for c in dev_cmds] == \
        [_cmd_tuple(c) for c in host_cmds]
