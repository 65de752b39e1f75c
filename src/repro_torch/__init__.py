"""repro_torch — the CXL-tiering system on PyTorch and CUDA (H100).

A port of the ``repro`` JAX package, which stays the reference.  Entry
points run on the card unless the caller passes ``device="cpu"``; see
:mod:`repro_torch.device`.  The CUDA kernels under ``csrc/`` are built at
first use (:mod:`repro_torch.kernels.common`)."""
