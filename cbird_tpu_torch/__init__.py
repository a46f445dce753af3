"""cbird_tpu_torch: the cbird-tpu dct main path on PyTorch and CUDA.

A second package beside ``cbird_tpu`` (the JAX reference, which stays as
it is).  It runs the default workflow with the default algorithm ``dct``:

- ``-update`` hashes images (``ops/dct_hash.py``, plain PyTorch matmuls);
- ``-similar`` / ``-similar-to`` search the packed hash store
  (``ops/hamming.py``) through hand-written CUDA kernels:
  ``ops/count_below.py`` (the count gate and the self-search triangle),
  ``ops/band_count.py`` (the pigeonhole self-search count phase of
  ``ops/pigeonhole.py``) and ``ops/hamming_topk.py`` (the exact per-needle
  top-k).

The package imports neither ``jax`` nor ``cbird_tpu``: it keeps its own
copies of the JAX package's jax-free modules (params, store, index base
and cache, the CLI filters, the numpy tables it needs), at the same
relative paths, so the SQLite schema, the ``_index/`` caches and ``.vdx``
files stay byte-compatible between the two packages.

Layer map:
    cli/      ``cbird-torch``: the command-line interpreter on the Engine
    host/     engine and scanner (directory walk, decode, batched hashing)
    store/    SQLite database, media records, file digests, .vdx files
    index/    the index contract, the sidecar cache, the dct index
    ops/      hashing, the hash store, pigeonhole, the kernel wrappers
    csrc/     CUDA C++ kernels for sm_90a, built at first use (_build.py)
    params.py, utils/   search and index parameters, logging, environment
"""

__version__ = "0.1.0"
