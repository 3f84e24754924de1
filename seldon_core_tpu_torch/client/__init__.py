"""Client SDK of the port: ``SeldonTpuClient`` and ``RawFrameClient``."""
