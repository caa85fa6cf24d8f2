"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` under ``repro_torch/kernels`` compiles to its own
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>.so <name>.cu

into ``build/repro_torch/<name>-<hash>/`` at the repository root, keyed by
a hash of the source, every header of the package (a source may include
another directory's) and the flags, at first use.  :func:`build_all`
starts one ``nvcc`` per source, all at once.  A failed build raises with
``nvcc``'s stderr; nothing falls back.  Nothing here runs at import time.

:data:`AUDIT` is the one place an exactness audit (analysis/exactness.py)
sees a kernel: None unless an audit records, else called after each
launch as ``AUDIT(name, reads, writes)`` with the tensors the kernel read
as operands and the tensors it wrote.

:data:`CAPTURE` is the one switch that makes every kernel wrapper call its
kernel as a ``torch.library`` custom op (``repro_torch::<name>``): True
only while ``launch/graph_analysis.py:capture`` traces a step, so that each
launch is one node of the captured graph.  :func:`as_op` is the wrappers'
test: a capture is active, or the operand is a ``meta`` tensor on the
card's path (device.py:card_path), whose op returns its output's shape and
dtype and counts the kernel's work (the dry run).  The eager paths are
untouched: a CUDA tensor launches, a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["sources", "build_all", "load", "launch", "note_launch",
           "BUILD_DIR", "AUDIT", "CAPTURE", "as_op"]

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[str, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()

#: the kernel hook of an active exactness audit (None: no audit records)
AUDIT = None
#: True while a graph capture traces (launch/graph_analysis.py:capture)
CAPTURE = False


def as_op(x) -> bool:
    """Does a wrapper call its kernel as its custom op for operand ``x``:
    inside a capture, or on a ``meta`` tensor that takes the card's path."""
    if CAPTURE:
        return True
    if not x.is_meta:
        return False
    from repro_torch.device import card_path

    return card_path(x)


def sources() -> dict[str, Path]:
    """Every CUDA source of the package, by library name."""
    return {p.stem: p for p in sorted(_KERNELS.glob("**/csrc/*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                       "the CUDA kernels cannot be built on this host")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(_KERNELS.glob("**/csrc/*.cuh")):  # what it includes
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}" / f"lib{src.stem}.so"


def _start(src: Path) -> tuple[Path, subprocess.Popen | None]:
    out = _target(src)
    if out.exists():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _finish(src: Path, out: Path, proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    stdout, stderr = proc.communicate()
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{stderr}{stdout}")
    # ptxas -v: registers, shared memory and spills of every kernel
    out.with_suffix(".log").write_text(stderr + stdout)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> dict[str, Path]:
    """Compile every source that has no library yet, one ``nvcc`` each,
    all started together.  Returns the library path per name."""
    started = {name: (src, *_start(src)) for name, src in sources().items()}
    for src, out, proc in started.values():
        _finish(src, out, proc)
    return {name: out for name, (_, out, _) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            src = sources()[name]
            out, proc = _start(src)
            _finish(src, out, proc)
            lib = _LIBS[name] = ctypes.CDLL(str(out))
        return lib


def note_launch(name: str, reads: tuple, writes: tuple) -> None:
    """Tell an active audit that kernel ``name`` read ``reads`` (its
    operands) and wrote ``writes``; nothing when no audit records."""
    if AUDIT is not None:
        AUDIT(name, reads, writes)


def launch(name: str, argtypes: list, dev, what: str, *args,
           reads: tuple = (), writes: tuple = (),
           entry: str | None = None) -> None:
    """Call the C entry ``entry`` (by default ``name``) of ``csrc/<name>.cu``
    (built on first use) with ``args`` and the current stream of the card
    ``dev``.  The entry returns a ``cudaError_t``; anything but 0 raises,
    naming ``what``.  ``reads`` and ``writes`` (the operand and output
    tensors behind the pointers) go to :data:`AUDIT` when an audit
    records."""
    import torch

    entry = entry or name
    fn = _FNS.get(entry)
    if fn is None:
        fn = getattr(load(name), entry)
        fn.argtypes = [*argtypes, ctypes.c_void_p]  # the stream last
        fn.restype = ctypes.c_int
        _FNS[entry] = fn
    err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name(dev)}, {what})")
    note_launch(name, reads, writes)
