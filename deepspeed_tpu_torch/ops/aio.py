"""Async host file IO (ctypes binding of ``csrc/host/async_io.cpp``).

Port of ``deepspeed_tpu/ops/aio.py`` (``AsyncIOHandle`` :38) over CPU
tensors: asynchronous pread / pwrite of contiguous host buffers against
local storage, for the NVMe tier of the optimizer offload
(``runtime/zero/offload.py``). A request runs on the handle's thread pool
while Python goes on; the handle keeps a reference to each request's
tensor until the request is waited.
"""

from ctypes import c_char_p, c_int, c_int64, c_void_p
from typing import Dict, Optional

import torch

from .op_builder.cpu import AsyncIOBuilder

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = AsyncIOBuilder().load()
        lib.ds_aio_handle_create.restype = c_void_p
        lib.ds_aio_handle_create.argtypes = [c_int64, c_int]
        lib.ds_aio_handle_destroy.argtypes = [c_void_p]
        for fn in (lib.ds_aio_pread, lib.ds_aio_pwrite):
            fn.restype = c_int64
            fn.argtypes = [c_void_p, c_char_p, c_void_p, c_int64, c_int64]
        lib.ds_aio_wait.restype = c_int64
        lib.ds_aio_wait.argtypes = [c_void_p, c_int64]
        lib.ds_aio_wait_all.restype = c_int64
        lib.ds_aio_wait_all.argtypes = [c_void_p]
        _lib = lib
    return _lib


class AsyncIOHandle:
    """Reference aio_handle(block_size, queue_depth, single_submit,
    overlap_events, num_threads); block_size and num_threads are the knobs
    of the thread-pool backend."""

    def __init__(self, block_size: int = 1 << 20, num_threads: int = 8):
        self._lib = _load()
        self._h: Optional[int] = self._lib.ds_aio_handle_create(
            block_size, num_threads)
        self.block_size = block_size
        self.num_threads = num_threads
        self._live: Dict[int, torch.Tensor] = {}

    def _buf(self, t: torch.Tensor):
        if t.device.type != "cpu" or not t.is_contiguous():
            raise ValueError("AIO buffers must be contiguous CPU tensors")
        return t.data_ptr(), t.numel() * t.element_size()

    def _submit(self, fn, path, t: torch.Tensor, file_offset: int) -> int:
        ptr, nbytes = self._buf(t)
        req = fn(self._h, str(path).encode(), ptr, nbytes, file_offset)
        self._live[req] = t
        return req

    def pread(self, path: str, t: torch.Tensor, file_offset: int = 0) -> int:
        return self._submit(self._lib.ds_aio_pread, path, t, file_offset)

    def pwrite(self, path: str, t: torch.Tensor, file_offset: int = 0) -> int:
        return self._submit(self._lib.ds_aio_pwrite, path, t, file_offset)

    def wait(self, req_id: int) -> int:
        got = self._lib.ds_aio_wait(self._h, req_id)
        self._live.pop(req_id, None)
        if got < 0:
            raise OSError(-got, f"aio request {req_id} failed")
        return got

    def wait_all(self):
        err = self._lib.ds_aio_wait_all(self._h)
        self._live.clear()
        if err < 0:
            raise OSError(-err, "aio wait_all: a request failed")

    # synchronous conveniences (reference sync_pread/sync_pwrite)
    def sync_pread(self, path: str, t: torch.Tensor,
                   file_offset: int = 0) -> int:
        return self.wait(self.pread(path, t, file_offset))

    def sync_pwrite(self, path: str, t: torch.Tensor,
                    file_offset: int = 0) -> int:
        return self.wait(self.pwrite(path, t, file_offset))

    def close(self):
        if self._h is not None:
            self._lib.ds_aio_handle_destroy(self._h)
            self._h = None
            self._live.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
