"""The card's SM clock, temperature, power draw and clock-event reasons,
read in the process through NVML (``libnvidia-ml``, the library that
``nvidia-smi`` reads); ``read`` returns None where the library or the
card is not there, as on the CPU."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

NVML_CLOCK_SM = 1
NVML_TEMPERATURE_GPU = 0


class Card:
    def __init__(self, index: int = 0):
        self.lib, self.handle = None, ctypes.c_void_p()
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
            if lib.nvmlInit_v2() == 0 and lib.nvmlDeviceGetHandleByIndex_v2(
                    index, ctypes.byref(self.handle)) == 0:
                self.lib = lib
        except (OSError, AttributeError):
            pass

    def read(self) -> Optional[Tuple[int, int, float, int]]:
        """(SM MHz, °C, W, clock-event reason bits), or None."""
        if self.lib is None:
            return None
        clock, temp, mw = ctypes.c_uint(), ctypes.c_uint(), ctypes.c_uint()
        reasons = ctypes.c_ulonglong()
        h = self.handle
        if (self.lib.nvmlDeviceGetClockInfo(h, NVML_CLOCK_SM,
                                            ctypes.byref(clock))
                or self.lib.nvmlDeviceGetTemperature(
                    h, NVML_TEMPERATURE_GPU, ctypes.byref(temp))
                or self.lib.nvmlDeviceGetPowerUsage(h, ctypes.byref(mw))
                or self.lib.nvmlDeviceGetCurrentClocksThrottleReasons(
                    h, ctypes.byref(reasons))):
            return None
        return clock.value, temp.value, mw.value / 1e3, reasons.value
