"""The sgemm2x app's blocked matrix product: the CUDA kernel and its plain
torch version.

Counterpart of the Pallas TPU kernel ``skybox_rt_tpu.apps.compute.
_sgemm_kernel`` (launched by ``sgemm_pallas``).  The kernel,
``csrc/apps_sgemm.cu``, says how it is laid out and what bounds it.
:func:`sgemm`:

  * a CUDA tensor launches the kernel on the current stream, or raises;
  * a CPU tensor runs :func:`sgemm_reference`.

Both sum every element of C over k in ascending order, one fused
multiply-add at a time, ``acc = fmaf(a[i, k], b[k, j], acc)`` from +0 (the
exact ``a * b + acc`` rounded once to float32), so they agree bit for bit.
Against ``torch.matmul`` or the JAX package (whose blocks are summed by a
dot of their own) they agree to a float tolerance only.
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


def fma_reference(a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor) -> torch.Tensor:
    """float32 ``fmaf(a, b, c)`` in plain torch on any device (broadcast):
    the exact ``a * b + c`` rounded once to nearest, ties to even, for
    finite results.

    ``p = a * b`` is exact in float64 (48 significant bits); ``s = p + c``
    rounds, and TwoSum gives its exact error ``e``.  ``s`` rounded to float32
    is the answer unless ``s`` lies exactly halfway between two float32
    values and ``e != 0``: then the exact sum is off the midpoint, on
    ``e``'s side, and the answer is the neighbour on that side."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.float()
    r64 = r.double()
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(s > r64, inf, -inf))
    o64 = other.double()
    tie = (r64 != s) & (r64 + o64 == 2 * s) & (e != 0)
    toward_other = (e > 0) == (o64 > s)
    return torch.where(tie & toward_other, other, r)


def sgemm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch C = A . B on any device, in the kernel's arithmetic:
    ``acc = fmaf(a[:, k], b[k, :], acc)`` for ascending k from +0
    (:func:`fma_reference`, about 15 float64 operations a step)."""
    m, k = a.shape
    n = b.shape[1]
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for kk in range(k):
        acc = fma_reference(a[:, kk:kk + 1], b[kk:kk + 1, :], acc)
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
