"""Hand-written CUDA kernels: one ``csrc/<name>.cu`` each, with a plain
PyTorch version (``ref.py``), the launch (``kernel.py``) and the public
wrapper with its launch counter (``ops.py``)."""
