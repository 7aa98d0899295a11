"""Stages of the pair stitch and the wrappers of the CUDA kernels
(``cuda_*.py``, sources in ``pano_tpu_torch/csrc``)."""
