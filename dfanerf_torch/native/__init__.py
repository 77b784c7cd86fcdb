"""Host extensions in C++ (ctypes, extern "C"), built with g++ at first use:
the port's copy of the reference package's native NMS."""

from dfanerf_torch.native.build import load_library

__all__ = ["load_library"]
