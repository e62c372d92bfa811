"""The benchmark process's allocator setting (``ocbench/host.py``)."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import ctypes, sys
sys.path.insert(0, sys.argv[1])
from ocbench.host import keep_freed_memory
assert keep_freed_memory()
# a block far above glibc's largest mmap threshold, freed and taken again:
# it now comes from the heap, and the memory stays in the process
libc = ctypes.CDLL("libc.so.6")
libc.malloc.restype = ctypes.c_void_p
libc.malloc.argtypes = (ctypes.c_size_t,)
libc.free.argtypes = (ctypes.c_void_p,)
libc.sbrk.restype = ctypes.c_void_p
libc.sbrk.argtypes = (ctypes.c_long,)
top0 = libc.sbrk(0)
p = libc.malloc(64 << 20)
assert libc.sbrk(0) - top0 >= 64 << 20, "the block was not taken from the heap"
libc.free(p)
assert libc.sbrk(0) - top0 >= 64 << 20, "the heap was trimmed"
print("ok")
"""


@pytest.mark.skipif(not sys.platform.startswith("linux"),
                    reason="glibc's mallopt")
def test_large_blocks_come_from_the_heap_and_stay():
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
