"""The benchmark process's host memory: freed memory stays in the process.

The program's commit builds host buffers of tens to hundreds of MB for
every chunk it encodes (the D2H copy of the KV, the widened float32 and the
stacked K/V).  Under glibc's defaults each buffer above 32 MB is a fresh
``mmap``, so every chunk pays page faults and the zeroing of new pages, a
cost that swings with what else the host is doing.  A serving deployment
keeps that memory in its arena; ``keep_freed_memory`` does so: no ``mmap``
for large blocks, no trimming of the heap's top.  Uses only the standard
library, so it can run before numpy and torch are imported.
"""
import ctypes
import ctypes.util

M_TRIM_THRESHOLD = -1  # glibc's mallopt parameters (malloc.h)
M_MMAP_MAX = -4


def keep_freed_memory() -> bool:
    """Set glibc's allocator to serve large blocks from its heap and never
    hand freed memory back to the system.  False where the C library is not
    glibc (nothing is changed then)."""
    name = ctypes.util.find_library("c") or "libc.so.6"
    try:
        libc = ctypes.CDLL(name)
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
    mallopt.restype = ctypes.c_int
    # the trim threshold is an int here: its largest value, about 2 GiB,
    # is above any block the program frees
    return bool(mallopt(M_TRIM_THRESHOLD, 2**31 - 1)
                and mallopt(M_MMAP_MAX, 0))
