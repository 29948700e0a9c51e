"""The port's runtime.device facade on the CPU, beside the JAX package's.

The capabilities carry the JAX package's field names, an upload/download
round trip returns the array and counts its bytes as the JAX facade counts
them, a read-only buffer refuses a write with DeviceError, and run() with a
timeout returns.  Without a card ``Device()`` raises, as every entry point of
the port does.
"""
import dataclasses

import numpy as np
import pytest
import torch

from skybox_rt_tpu.runtime import device as jax_device
from skybox_rt_tpu_torch.runtime.device import Buffer, Device, DeviceError

torch.set_num_threads(1)


def test_caps_have_the_jax_fields():
    caps = Device("cpu").caps
    assert [f.name for f in dataclasses.fields(caps)] == \
        [f.name for f in dataclasses.fields(jax_device.DeviceCaps)]
    assert caps.platform == "cpu" and caps.num_devices == 1
    assert caps.has_raster and caps.has_tex and caps.has_om and caps.has_rt


@pytest.mark.parametrize("dtype", [np.uint32, np.float32, np.int32])
def test_round_trip_counts_bytes_as_jax(dtype):
    host = np.arange(64, dtype=dtype).reshape(8, 8)
    counts = []
    for dev, buffer in ((Device("cpu"), Buffer),
                        (jax_device.Device("cpu"), jax_device.Buffer)):
        buf = dev.upload(host, access=buffer.READ | buffer.WRITE)
        out = dev.download(buf)
        np.testing.assert_array_equal(out, host)
        assert out.dtype == host.dtype
        counts.append(dict(dev.perf.counters))
    assert counts[0] == counts[1] == {"host_to_device_bytes": host.nbytes,
                                      "device_to_host_bytes": host.nbytes}


def test_readonly_buffer_rejects_write():
    buf = Device("cpu").upload(np.zeros(4, np.float32), access=Buffer.READ)
    with pytest.raises(DeviceError):
        buf.write(np.ones(4, np.float32))


def test_buffer_write_checks_shape_and_keeps_device():
    dev = Device("cpu")
    buf = dev.upload(np.zeros(4, np.float32), access=Buffer.WRITE)
    with pytest.raises(DeviceError):
        buf.write(np.zeros(8, np.float32))
    with pytest.raises(DeviceError):
        buf.write(np.zeros(4, np.int32))
    buf.write(np.ones(4, np.float32))
    assert buf.array.device.type == "cpu"
    np.testing.assert_array_equal(dev.download(buf), np.ones(4, np.float32))


@pytest.mark.parametrize("timeout_s", [None, 5.0])
def test_run_returns_and_counts(timeout_s):
    dev = Device("cpu")
    buf = dev.upload(np.arange(8, dtype=np.float32))
    out = dev.run(lambda x: x * 2, buf.array, timeout_s=timeout_s)
    np.testing.assert_array_equal(out.numpy(), np.arange(8) * 2.0)
    assert dev.perf.counters["kernel_launches"] == 1
    assert dev.perf.times_ms["device_ms"] > 0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert Device().caps.platform == "gpu"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Device()
