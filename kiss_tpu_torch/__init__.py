"""kiss_tpu_torch: the PyTorch + CUDA port of kiss-tpu.

k-ordered suffix arrays and k-ordered FM-indexes for genome-scale DNA
(the capabilities of jhhung/kISS) on one NVIDIA GPU. The JAX package
``kiss_tpu`` beside it is the reference this port is held against; this
package imports neither JAX nor ``kiss_tpu``.

Public API mirrors ``kiss_tpu``'s module and function names:
  - suffix sorting: :mod:`kiss_tpu_torch.ops.suffix_sort` (in-core, DNA
    and general alphabet), :mod:`kiss_tpu_torch.ops.external_sort`
    (out-of-core), :mod:`kiss_tpu_torch.ops.lms_native` (host LMS +
    induced sort)
  - FM-index: :mod:`kiss_tpu_torch.models.fm_index`
  - the device mesh behind ``-t N``: :mod:`kiss_tpu_torch.parallel`
  - CLI: ``python -m kiss_tpu_torch suffix_sort|fmindex_build|
    fmindex_query|serve ... [--device cuda|cpu]``
  - measurements: :mod:`kiss_tpu_torch.experiments` (the card's probes,
    the reference's experiment protocol, the out-of-core routes at scale)

Hand-written CUDA kernels (``kiss_tpu_torch/csrc/``) carry the multi-word
sort, the backward search, the locate walk and the probes on the GPU;
each has a plain PyTorch version that runs on CPU tensors.
"""

VERSION = "1.0.0"

BANNER = (
    r""" _     ___  ____  ____        _
| | __|_ _|/ ___|/ ___|      | |_ _ __  _   _
| |/ / | | \___ \\___ \ _____| __| '_ \| | | |
|   <  | |  ___) |___) |_____| |_| |_) | |_| |
|_|\_\|___||____/|____/       \__| .__/ \__,_|
                                 |_|          """
    + VERSION
    + "\n"
)

from kiss_tpu_torch.ops.lms_native import LmsSorter  # noqa: E402,F401
from kiss_tpu_torch.ops.suffix_sort import (  # noqa: E402,F401
    Kiss1Sorter,
    Kiss2Sorter,
    k_ordered_suffix_array,
)
