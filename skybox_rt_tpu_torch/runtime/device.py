"""Device facade — the public runtime API (vortex.h analog, SURVEY §2.2 H1).

Counterpart of skybox_rt_tpu.runtime.device.  The reference exposes
open/caps/alloc/copy/start/ready_wait/dcr_write
(runtime/include/vortex.h:74-139).  Under PyTorch the equivalents are:

  vx_dev_open / vx_dev_caps      -> Device() / Device.caps
  vx_mem_alloc + vx_copy_to_dev  -> Device.upload (with access validation,
                                    the ACL concept of sim/common/mem.h:159)
  vx_copy_from_dev               -> Device.download
  vx_dcr_write                   -> RenderState construction (core.state)
  vx_start + vx_ready_wait       -> Device.run (dispatch + wait)
  vx_mpm_query / vx_dump_perf    -> Device.perf / Device.dump_perf

``Device(device=None)`` is the CUDA card and raises without one
(core.device.resolve_device); ``Device("cpu")`` is the host.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.device import resolve_device
from . import perf as perf_mod


class DeviceError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class DeviceCaps:
    """vx_dev_caps analog (VX_CAPS_*, vortex.h:30-40)."""
    platform: str
    num_devices: int
    device_kind: str
    memory_per_device: int | None
    # ISA-flag analog: which pipeline extensions this build provides
    has_raster: bool = True
    has_tex: bool = True
    has_om: bool = True
    has_rt: bool = True


class Buffer:
    """Device buffer handle with access flags (vx_mem_alloc's
    VX_MEM_READ / VX_MEM_READ_WRITE, enforced like the ACL manager)."""

    READ = 1
    WRITE = 2

    def __init__(self, array: torch.Tensor, access: int):
        self._array = array
        self.access = access

    @property
    def array(self) -> torch.Tensor:
        return self._array

    def write(self, new_array):
        if not (self.access & Buffer.WRITE):
            raise DeviceError("buffer is read-only (VX_MEM_READ)")
        new = (new_array if torch.is_tensor(new_array)
               else torch.from_numpy(np.ascontiguousarray(new_array)))
        if (tuple(new.shape) != tuple(self._array.shape)
                or new.dtype != self._array.dtype):
            raise DeviceError(
                f"shape/dtype mismatch: {tuple(new.shape)}/{new.dtype} "
                f"vs {tuple(self._array.shape)}/{self._array.dtype}")
        # the buffer stays on the device it was allocated on (the vx_mem
        # placement contract)
        self._array = new.to(self._array.device)


class Device:
    """One logical accelerator: the CUDA card (``device=None``) or the
    named torch device."""

    def __init__(self, device=None):
        self._device = resolve_device(device)
        if (self._device.type == "cuda"
                and torch.cuda.device_count() == 0):
            raise DeviceError("no devices")
        self.perf = perf_mod.PerfCounters()

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def caps(self) -> DeviceCaps:
        if self._device.type == "cuda":
            index = (self._device.index if self._device.index is not None
                     else torch.cuda.current_device())
            props = torch.cuda.get_device_properties(index)
            # "gpu" is the platform name JAX gives an NVIDIA device
            return DeviceCaps(platform="gpu",
                              num_devices=torch.cuda.device_count(),
                              device_kind=props.name,
                              memory_per_device=int(props.total_memory))
        return DeviceCaps(platform=self._device.type, num_devices=1,
                          device_kind=self._device.type,
                          memory_per_device=None)

    def upload(self, host_array, access: int = Buffer.READ) -> Buffer:
        """vx_mem_alloc + vx_copy_to_dev."""
        host = torch.from_numpy(np.ascontiguousarray(host_array))
        arr = host.to(self._device)
        self.perf.count("host_to_device_bytes",
                        arr.numel() * arr.element_size())
        return Buffer(arr, access)

    def download(self, buf: Buffer) -> np.ndarray:
        """vx_copy_from_dev."""
        out = buf.array.detach().cpu().numpy()
        self.perf.count("device_to_host_bytes", out.nbytes)
        return out

    def run(self, fn, *args, timeout_s: float | None = None):
        """vx_start + vx_ready_wait: dispatch and wait until done.

        timeout_s mirrors vx_ready_wait's polling timeout
        (runtime/simx/vortex.cpp:195-209): on the card a CUDA event recorded
        after ``fn``'s launches is polled until the deadline, past which a
        hung dispatch raises DeviceError instead of waiting forever.  Work
        on the CPU has finished when ``fn`` returns.
        """
        t0 = time.perf_counter()
        out = fn(*args)
        if self._device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            if timeout_s is None:
                done.synchronize()
            else:
                deadline = t0 + timeout_s
                poll = min(max(timeout_s / 100.0, 0.001), 1.0)
                while not done.query():
                    if time.perf_counter() > deadline:
                        raise DeviceError(
                            f"device run exceeded {timeout_s}s timeout")
                    time.sleep(poll)
                done.synchronize()   # surface any execution error
        self.perf.count("kernel_launches", 1)
        self.perf.add_time("device_ms", (time.perf_counter() - t0) * 1e3)
        return out

    def dump_perf(self, file=None):
        """vx_dump_perf analog."""
        self.perf.dump(file=file)
