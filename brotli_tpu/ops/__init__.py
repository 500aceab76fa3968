"""Device code: the GPU batch decoder and the XLA device encoder."""
