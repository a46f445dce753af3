"""cbird_tpu_torch: the cbird-tpu dct main path and video on PyTorch and CUDA.

A second package beside ``cbird_tpu`` (the JAX reference, which stays as
it is).  It runs the default workflow with the default algorithm ``dct``,
and the video algorithm:

- ``-update`` hashes images (``ops/dct_hash.py``, plain PyTorch matmuls);
- ``-similar`` / ``-similar-to`` search the packed hash store
  (``ops/hamming.py``) through hand-written CUDA kernels:
  ``ops/count_below_mma.py`` (the count gate and the self-search
  triangle, on the int8 tensor cores),
  ``ops/band_count.py`` (the pigeonhole self-search count phase of
  ``ops/pigeonhole.py``) and ``ops/hamming_topk.py`` (the exact per-needle
  top-k);
- ``-p.alg video``: ``host/video.py`` decodes videos on host threads and
  hashes their frames on the device; ``index/dct_video_index.py`` searches
  the packed frame store (``ops/video_search.py``) with the same count
  gate.
- ``-p.tm``: ``host/template_matcher.py`` verifies candidates with ORB on
  the device and a mutual match on the 256-bit k-nearest kernel
  (``ops/hamming_lanes.py``); ``-serve`` and ``-browse`` (``cli/serve.py``,
  ``cli/browser.py``) keep an engine resident.

The package imports neither ``jax`` nor ``cbird_tpu``: it keeps its own
copies of the JAX package's jax-free modules (params, store, index base
and cache, the CLI filters, the numpy tables it needs), at the same
relative paths, so the SQLite schema, the ``_index/`` caches and ``.vdx``
files stay byte-compatible between the two packages.

Layer map:
    cli/      ``cbird-torch``: the command-line interpreter on the Engine,
              the query server and the result browser
    host/     engine, scanner (directory walk, decode, batched hashing),
              video ingest, the template matcher, the NLE project export
    store/    SQLite database, media records, file digests, .vdx files,
              the index thumbnail
    index/    the index contract, the sidecar cache, the dct and video indexes
    ops/      hashing, the hash and video stores, pigeonhole, the kernel
              wrappers
    csrc/     CUDA C++ kernels for sm_90a, built at first use (_build.py)
    params.py, utils/   search and index parameters, logging, environment
"""

__version__ = "0.1.0"
