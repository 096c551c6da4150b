"""ctypes loader for the native C++ runtime (libtpurag.so).

The native library accelerates the host-side hot paths around the device:
tokenization + term counting for inverted-index builds (the reference
outsources this to the Rust Meilisearch server). Built by
``tpurag/native/build.sh``; every entry point has a pure-Python fallback,
so the library is an accelerator, never a requirement.
"""

from __future__ import annotations

import ctypes
import json
import pathlib

_LIB_PATH = pathlib.Path(__file__).parent / "libtpurag.so"
_lib = None
_load_failed = False


def _load():
    global _lib, _load_failed
    if _lib is None and not _load_failed and _LIB_PATH.exists():
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.tr_term_counts_json.restype = ctypes.c_void_p
            lib.tr_term_counts_json.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.tr_free.argtypes = [ctypes.c_void_p]
            lib.tr_tokenize_count.restype = ctypes.c_size_t
            lib.tr_tokenize_count.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            try:  # batch ABI (round-2 .so); absent in older builds
                lib.tr_batch_term_counts.restype = ctypes.c_void_p
                lib.tr_batch_term_counts.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
                    ctypes.c_uint64]
            except AttributeError:
                lib.tr_batch_term_counts = None
            try:  # grouped-postings ABI (round-3 .so)
                lib.tr_batch_postings.restype = ctypes.c_void_p
                lib.tr_batch_postings.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
                    ctypes.c_uint64]
            except AttributeError:
                lib.tr_batch_postings = None
            _lib = lib
        except OSError:
            _load_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def term_counts(text: str) -> dict[str, int]:
    """Tokenize text and return {term: frequency} via the C++ tokenizer."""
    lib = _load()
    raw = text.encode("utf-8")
    ptr = lib.tr_term_counts_json(raw, len(raw))
    try:
        return json.loads(ctypes.string_at(ptr).decode("utf-8"))
    finally:
        lib.tr_free(ptr)


def token_count(text: str) -> int:
    lib = _load()
    raw = text.encode("utf-8")
    return int(lib.tr_tokenize_count(raw, len(raw)))


def batch_available() -> bool:
    lib = _load()
    return lib is not None and getattr(lib, "tr_batch_term_counts", None) \
        is not None


def postings_available() -> bool:
    lib = _load()
    return lib is not None and getattr(lib, "tr_batch_postings", None) \
        is not None


def batch_postings(texts):
    """Tokenize + count + group-by-term a BATCH of docs in one native call.

    Returns (terms, doc_total, gcount, gdoc, gcnt):
      terms:     list[str] — batch-unique terms in first-occurrence order
      doc_total: np.uint32 (n_docs,) — total tokens per doc (-> doc_len)
      gcount:    np.uint32 (n_unique,) — docs containing term u
      gdoc:      np.uint32 (total_pairs,) — doc index in batch, grouped by
                 term u ascending (doc arrival order within each term)
      gcnt:      np.uint32 (total_pairs,) — term frequency for each pair
    One C call + four zero-copy numpy views replace the Python side's
    argsort/diff grouping (see tokenizer.cc:tr_batch_postings)."""
    import numpy as np

    lib = _load()
    bufs = [t.encode("utf-8") for t in texts]
    blob = b"".join(bufs)
    offs = np.zeros(len(bufs) + 1, np.uint64)
    if bufs:
        np.cumsum([len(b) for b in bufs], out=offs[1:])
    ptr = lib.tr_batch_postings(
        blob, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(bufs))
    try:
        total = int.from_bytes(ctypes.string_at(ptr, 4), "little")
        raw = ctypes.string_at(ptr, total)
    finally:
        lib.tr_free(ptr)
    n_unique, arena_bytes, n_docs, total_pairs = (
        int(x) for x in np.frombuffer(raw, np.uint32, count=4, offset=4))
    terms = []
    pos = 20
    for _ in range(n_unique):
        ln = int.from_bytes(raw[pos:pos + 4], "little")
        terms.append(raw[pos + 4:pos + 4 + ln].decode("utf-8"))
        pos += 4 + ln
    base = 20 + arena_bytes
    doc_total = np.frombuffer(raw, np.uint32, count=n_docs, offset=base)
    base += 4 * n_docs
    gcount = np.frombuffer(raw, np.uint32, count=n_unique, offset=base)
    base += 4 * n_unique
    gdoc = np.frombuffer(raw, np.uint32, count=total_pairs, offset=base)
    gcnt = np.frombuffer(raw, np.uint32, count=total_pairs,
                         offset=base + 4 * total_pairs)
    return terms, doc_total, gcount, gdoc, gcnt


def batch_term_counts(texts):
    """Tokenize + term-count a BATCH of documents in one native call.

    Returns (terms, doc_terms, pairs):
      terms:     list[str] — batch-unique terms in first-occurrence order
      doc_terms: np.uint32 (n_docs,) — unique terms per document
      pairs:     np.uint32 (total_pairs, 2) — (term_idx, count), doc-major
    One C call + three zero-copy numpy views replace one JSON round-trip
    per document (see tokenizer.cc:tr_batch_term_counts for the layout).
    """
    import numpy as np

    lib = _load()
    bufs = [t.encode("utf-8") for t in texts]
    blob = b"".join(bufs)
    offs = np.zeros(len(bufs) + 1, np.uint64)
    if bufs:
        np.cumsum([len(b) for b in bufs], out=offs[1:])
    ptr = lib.tr_batch_term_counts(
        blob, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(bufs))
    try:
        total = int.from_bytes(ctypes.string_at(ptr, 4), "little")
        raw = ctypes.string_at(ptr, total)
    finally:
        lib.tr_free(ptr)
    n_unique, arena_bytes, n_docs, total_pairs = np.frombuffer(
        raw, np.uint32, count=4, offset=4)
    terms = []
    pos = 20
    for _ in range(int(n_unique)):
        ln = int.from_bytes(raw[pos:pos + 4], "little")
        terms.append(raw[pos + 4:pos + 4 + ln].decode("utf-8"))
        pos += 4 + ln
    base = 20 + int(arena_bytes)
    doc_terms = np.frombuffer(raw, np.uint32, count=int(n_docs),
                              offset=base)
    pairs = np.frombuffer(raw, np.uint32, count=int(total_pairs) * 2,
                          offset=base + 4 * int(n_docs)
                          ).reshape(-1, 2)
    return terms, doc_terms, pairs
