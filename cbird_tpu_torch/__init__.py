"""cbird_tpu_torch: the cbird-tpu dct main path on PyTorch and CUDA.

A second package beside ``cbird_tpu`` (the JAX reference, which stays as
it is).  It runs the default workflow with the default algorithm ``dct``:

- ``-update`` hashes images (``ops/dct_hash.py``, plain PyTorch matmuls);
- ``-similar`` / ``-similar-to`` search the packed hash store
  (``ops/hamming.py``) through two hand-written CUDA kernels:
  ``ops/count_below.py`` (the count gate and the self-search triangle) and
  ``ops/hamming_topk.py`` (the exact per-needle top-k).

Modules of ``cbird_tpu`` whose imports never reach ``jax`` (params,
store, index base and cache, the numpy goldens, the CLI filters and
reports) are imported, not copied, so ``_index/`` stays byte-compatible
between the two packages.  This package never imports ``jax``.

Layer map:
    cli/      ``cbird-torch``: the reference Cli with the port's Engine
    host/     engine and scanner (directory walk, decode, batched hashing)
    index/    the dct index on the port's store
    ops/      hashing, the hash store, the kernel wrappers
    csrc/     CUDA C++ kernels for sm_90a, built at first use (_build.py)
"""

__version__ = "0.1.0"
