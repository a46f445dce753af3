"""``cbird-torch``: the cbird command line on the PyTorch / CUDA port.

The reference interpreter ``cbird_tpu.cli.main.Cli`` (whose module imports
no ``jax``) with the port's ``Engine`` in its two construction points
(``engine()`` and ``-create``) and ``-about`` reporting torch and the
CUDA device.  Verbs that would reach a ``jax``-importing module of the
JAX package fail with "not ported yet" instead; so do ``-p.alg`` other
than dct and ``-p.tm``.

The device is CUDA unless ``CBIRD_TORCH_DEVICE=cpu`` selects the CPU.
Run as ``cbird-torch ...`` or ``python -m cbird_tpu_torch.cli.main ...``.
"""

from __future__ import annotations

import os
import sys

import torch

from cbird_tpu.cli.main import USAGE, Cli as ReferenceCli
from cbird_tpu.params import SearchParams
from cbird_tpu.utils.env import process_memory, system_memory
from cbird_tpu.utils.log import error, info

from .. import __version__
from ..host.engine import Engine
from ..host.scanner import NotPortedError

# verbs whose reference implementation imports a jax-bound module (the
# JAX scanner, video decode, template matcher) or a non-dct algorithm
NOT_PORTED = {
    "-browse", "-show", "-serve", "-verify", "-merge", "-select-grid",
    "-qualityscore", "-test-image-loader", "-test-image-search",
    "-test-video-decoder", "-test-video", "-list-formats", "-list-codecs",
    "-video-thumbnail", "-compare-videos", "-add-video",
}


class Cli(ReferenceCli):
    def __init__(self, device=None):
        super().__init__()
        self._device = device

    def engine(self):
        if self._engine is None:
            idx = os.path.join(self.index_dir, "_index")
            if not os.path.isdir(idx):
                error(f"no index found in {self.index_dir} (use -create)")
                sys.exit(2)
            self._engine = Engine(self.index_dir, self.index, self._device)
        return self._engine

    def run(self, args: list[str]) -> int:
        try:
            return super().run(args)
        except NotPortedError as e:
            error(str(e))
            return 2

    def _dispatch(self, args: list[str], i: int) -> int:
        a = args[i]
        if a in NOT_PORTED or (a == "-similar-to"
                               and os.environ.get("CBIRD_SERVER")):
            raise NotPortedError(f"{a} is not ported yet")
        if a == "-create":
            os.makedirs(os.path.join(self.index_dir, "_index"), exist_ok=True)
            self._engine = Engine(self.index_dir, self.index, self._device)
            info(f"created index in {self.index_dir}")
            return i + 1
        nxt = super()._dispatch(args, i)
        if a.startswith("-p."):
            if self.search.algo != SearchParams.ALGO_DCT:
                raise NotPortedError(f"{a} {args[i + 1]}: not ported yet "
                                     f"(only -p.alg dct is)")
            if self.search.templateMatch:
                raise NotPortedError("-p.tm is not ported yet")
        return nxt

    def _about(self) -> None:
        print(f"cbird-tpu-torch {__version__}")
        dev = "cpu"
        if torch.cuda.is_available():
            dev = (f"{torch.cuda.get_device_name(0)} "
                   f"(x{torch.cuda.device_count()})")
        print(f"torch {torch.__version__}; cuda {torch.version.cuda}; "
              f"device: {dev}")
        total, avail = system_memory()
        print(f"memory: process {process_memory() >> 20} MB; "
              f"system {avail >> 20}/{total >> 20} MB available")
        idx = os.path.join(self.index_dir, "_index")
        if os.path.isdir(idx):
            eng = self.engine()
            print(f"index: {idx}")
            print(f"items: {eng.db.count()}")
            for index in eng.db.indexes():
                state = "loaded" if index.is_loaded() else "not loaded"
                print(f"     dct: "
                      f"{index.count() if index.is_loaded() else '-'} items, "
                      f"{index.memory_usage()} bytes ({state})")


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(USAGE)
        return 0
    try:
        return Cli().run(list(argv))
    except BrokenPipeError:
        # stdout consumer (e.g. `| head`) closed early — not an error
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
