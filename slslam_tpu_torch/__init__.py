"""slslam_tpu_torch: the batch replay engine, global refine, deferred loop
closure, interactive engine, image front-end and distributed layer of
slslam_tpu in PyTorch + CUDA.

A port of the device-resident batch engine (``slslam_tpu.engine.batch``),
of the post-replay global refine (``slslam_tpu.engine.refine``), of
loop-closure mode (``slslam_tpu.engine.batch_lc``, ``loopclosure``,
``ops.pose_graph``), of the interactive engine (``engine.slam``), of
the image front-end (``frontend``: detector, descriptor, matcher) and of
the distributed layer (``parallel``, over ``torch.distributed``) to
PyTorch, with the BA evaluates and the index
reductions written by hand in CUDA C++ for Hopper (``csrc/``, bound through
ctypes in ``ops/kernels.py``), and the bench entry ``python3 -m
slslam_tpu_torch.bench``.  The JAX package stays the reference; this
package imports ``torch`` and numpy, never ``jax`` and nothing of
``slslam_tpu``: what it needs of the reference's modules it keeps as cited
copies (``config``, ``hostgeom``, ``sim``, ``evalio``, the vocabulary
training, and the numpy parts of ``engine/refine``, ``ops/schur_cg`` and
``engine/batch_lc``).

Every public function takes tensors on an explicit device; constructors
take an explicit ``device`` and ``dtype``.  Nothing falls back to the CPU
when CUDA is missing: :func:`resolve_device` raises.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and this
    machine has no usable CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    """'float32' / 'float64' / torch dtype -> torch dtype (floats only)."""
    if isinstance(dtype, torch.dtype):
        dt = dtype
    else:
        dt = {"float32": torch.float32, "float64": torch.float64}.get(
            str(dtype))
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported compute dtype {dtype!r}")
    return dt
