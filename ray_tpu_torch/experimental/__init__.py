"""ray_tpu_torch.experimental: device objects (the port of
ray_tpu.experimental)."""

from .device_objects import (
    DeviceObjectRef,
    device_get,
    device_put_object,
    free_device_object,
)

__all__ = [
    "DeviceObjectRef",
    "device_put_object",
    "device_get",
    "free_device_object",
]
