"""The sgemm2x app's blocked matrix product: the CUDA kernel and its plain
torch version.

Counterpart of the Pallas TPU kernel ``skybox_rt_tpu.apps.compute.
_sgemm_kernel`` (launched by ``sgemm_pallas``).  The kernel,
``csrc/apps_sgemm.cu``, says how it is laid out and what bounds it.
:func:`sgemm`:

  * a CUDA tensor launches the kernel on the current stream, or raises;
  * a CPU tensor runs :func:`sgemm_reference`.

Both sum every element of C over k in ascending order, one float32 product
and one float32 add at a time, each rounded on its own, so they agree bit for
bit.  Against ``torch.matmul`` or the JAX package (whose blocks are summed by
a dot of their own) they agree to a float tolerance only.
"""
from __future__ import annotations

import ctypes

import torch

# Kernel launches made by sgemm since the last reset: a run reads it to show
# that its main path went through the kernel.
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def sgemm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch C = A . B on any device, in the kernel's sum order:
    ``acc = acc + a[:, k] * b[k, :]`` for ascending k, the product and the
    add two separate roundings."""
    m, k = a.shape
    n = b.shape[1]
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for kk in range(k):
        acc = acc + a[:, kk:kk + 1] * b[kk:kk + 1, :]
    return acc


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sgemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C (m, n) float32 = A (m, k) float32 . B (k, n) float32."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"sgemm: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    dev = a.device
    m, k = a.shape
    n = b.shape[1]
    if dev.type == "cpu":
        if b.device != dev or a.dtype != torch.float32 or \
                b.dtype != torch.float32:
            raise TypeError("sgemm: a and b must be float32 on one device")
        return sgemm_reference(a, b)
    if dev.type != "cuda":
        raise ValueError(f"sgemm: unsupported device {dev}")
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"sgemm: a dimension of {(m, n, k)} passes int32")
    _check("a", a, (m, k), dev)
    _check("b", b, (k, n), dev)
    c = torch.empty((m, n), dtype=torch.float32, device=dev)

    from .. import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.skybox_apps_sgemm(
        ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
        ctypes.c_void_p(c.data_ptr()), m, n, k, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"apps_sgemm kernel launch failed: CUDA error {rc}")
    global launch_count
    launch_count += 1
    return c
