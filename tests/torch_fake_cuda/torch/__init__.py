"""A stand-in for ``torch`` with two fake CUDA cards, for the port's
lease-binding test (tests/test_torch_runtime.py).

The tests run on the CPU, and a CPU build of torch cannot bind a worker
to a card. The test puts this directory first on the path of its
cluster's workers, so a worker bound to a lease imports this module as
``torch``; only ``torch.cuda``'s device calls exist, and the current
device is each thread's own, as CUDA's is.
"""

from . import cuda  # noqa: F401


class Tensor:
    """No tensor exists here; the object plane's isinstance checks see none."""
