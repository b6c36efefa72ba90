"""The example scripts on the PyTorch port: each mirrors the script of the
same name in ``examples/`` (one of the reference's notebooks) step for
step, on the card by default (``main(out, device=None)`` raises without
one) or on the CPU with ``device="cpu"``.  They import only the port,
torch, numpy, scipy and the standard library."""
