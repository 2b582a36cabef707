"""Hand-written CUDA kernels with their plain PyTorch versions."""
import functools

import torch


@functools.cache
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``, which the
    launch geometries size their grids by."""
    return torch.cuda.get_device_properties(index).multi_processor_count
