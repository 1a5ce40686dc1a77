"""Native (C++) host-side components, loaded via ctypes.

``NativeAnalyzer`` wraps the C++ tokenizer/postings builder
(``analyzer.cpp``); it is a drop-in accelerator for the BM25 build path and
produces byte-identical postings to the Python analyzer (verified in
tests). The library builds on demand with ``ensure_built()`` (make + g++)
into ``build/ragmeup_tpu_torch/native/`` at the repository root; when no
toolchain is available everything falls back to pure Python (host code with
the same output, not a device fallback).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "ragmeup_tpu_torch", "native", "libraganalyzer.so")
_build_lock = threading.Lock()
_lib = None


def _sources_mtime() -> float:
    newest = 0.0
    for name in os.listdir(_DIR):
        if name.endswith(".cpp") or name == "Makefile":
            newest = max(newest, os.path.getmtime(os.path.join(_DIR, name)))
    return newest


def ensure_built(force: bool = False) -> Optional[str]:
    """Build the shared library if needed; returns its path or None.

    A stale .so (older than any source file — e.g. built before a new
    symbol was added) rebuilds automatically: a pre-existing library
    without simpletok_encode would make _load() raise on the symbol
    lookup."""
    with _build_lock:
        if os.path.exists(_LIB_PATH) and not force \
                and os.path.getmtime(_LIB_PATH) >= _sources_mtime():
            return _LIB_PATH
        # build under a private name, then rename: test workers in other
        # processes may load the library while this one builds it
        tmp = f"{_LIB_PATH}.{os.getpid()}"
        try:
            subprocess.run(["make", "-C", _DIR, "-s", f"LIB={tmp}"],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB_PATH)
        except (subprocess.SubprocessError, FileNotFoundError, OSError):
            return None
        return _LIB_PATH


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = ensure_built()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    if not hasattr(lib, "simpletok_encode"):
        # library predates the newest symbols and mtimes lied (copied
        # tree): force one rebuild before giving up
        path = ensure_built(force=True)
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        if not hasattr(lib, "simpletok_encode"):
            return None
    lib.analyzer_create.restype = ctypes.c_void_p
    lib.analyzer_destroy.argtypes = [ctypes.c_void_p]
    lib.analyzer_add_batch.restype = ctypes.c_int64
    lib.analyzer_add_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32]
    lib.analyzer_num_postings.restype = ctypes.c_int64
    lib.analyzer_num_postings.argtypes = [ctypes.c_void_p]
    lib.analyzer_postings.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)]
    lib.analyzer_clear_postings.argtypes = [ctypes.c_void_p]
    lib.analyzer_vocab_size.restype = ctypes.c_int64
    lib.analyzer_vocab_size.argtypes = [ctypes.c_void_p]
    lib.analyzer_vocab_bytes.restype = ctypes.c_int64
    lib.analyzer_vocab_bytes.argtypes = [ctypes.c_void_p]
    lib.analyzer_vocab.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.analyzer_num_docs.restype = ctypes.c_int64
    lib.analyzer_num_docs.argtypes = [ctypes.c_void_p]
    lib.analyzer_doc_lens.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int32)]
    lib.analyzer_load_vocab.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int64]
    lib.simpletok_encode.restype = ctypes.c_int64
    lib.simpletok_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeAnalyzer:
    """C++ tokenizer + postings builder (one instance per BM25Index)."""

    def __init__(self, vocab: Optional[Sequence[str]] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native analyzer unavailable (no toolchain?)")
        self._lib = lib
        self._h = lib.analyzer_create()
        if vocab:
            blob = ("\n".join(vocab) + "\n").encode("utf-8")
            lib.analyzer_load_vocab(self._h, blob, len(blob))

    def __del__(self):
        try:
            self._lib.analyzer_destroy(self._h)
        except Exception:
            pass

    def add_batch(self, texts: Sequence[str], row_start: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Tokenize texts → (tids, rows, tfs, doc_lens); postings buffer is
        drained per call so each batch returns only its own triplets."""
        lib = self._lib
        blobs = [t.encode("utf-8") for t in texts]
        offsets = np.zeros(len(blobs) + 1, np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        buf = b"".join(blobs)
        lib.analyzer_add_batch(
            self._h, buf, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(blobs), row_start)
        n = lib.analyzer_num_postings(self._h)
        tids = np.zeros(n, np.int32)
        rows = np.zeros(n, np.int32)
        tfs = np.zeros(n, np.float32)
        if n:
            lib.analyzer_postings(
                self._h, tids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                tfs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        nd = lib.analyzer_num_docs(self._h)
        doc_lens = np.zeros(nd, np.int32)
        if nd:
            lib.analyzer_doc_lens(
                self._h, doc_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        lib.analyzer_clear_postings(self._h)
        return tids, rows, tfs, doc_lens

    def vocab(self) -> List[str]:
        lib = self._lib
        nbytes = lib.analyzer_vocab_bytes(self._h)
        out = ctypes.create_string_buffer(int(nbytes))
        lib.analyzer_vocab(self._h, out)
        blob = out.raw[:nbytes].decode("utf-8")
        return blob.split("\n")[:-1]


def simpletok_encode(text: str, vocab_size: int,
                     n_special: int) -> Optional[List[int]]:
    """Native hashing-tokenizer fast path (simpletok.cpp). Returns None
    when unavailable or when the text needs the Python Unicode path."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode("utf-8")
    out = np.empty(max(len(raw), 1), np.int32)
    n = lib.simpletok_encode(raw, len(raw), vocab_size, n_special,
                             out.ctypes.data_as(
                                 ctypes.POINTER(ctypes.c_int32)))
    if n < 0:
        return None
    return out[:n].tolist()
