"""ctypes binding of the port's rANS library (`csrc/lssvc_rans.cpp`), the
twin of the JAX package's `native/rans.py`.

The reference's binding surface, batch-oriented: BufferedRansEncoder
(encode_with_indexes / flush / reset), the one-shot RansEncoder,
RansDecoder (set_stream / set_cdf / decode_stream / decode_with_indexes /
decode_stream_only_indexes) and pmf_to_quantized_cdf.  Symbols and
indexes are numpy int32 arrays and a CDF table is one 2-D int32 matrix, so
each tensor crosses into C in one call, never one call per element.  The
library is built with g++ into `lssvc_tpu_torch/_build/` at first use
(`build.load`), not at import.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import build

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("lssvc_rans")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.rans_encoder_new.restype = vp
        lib.rans_encoder_delete.argtypes = [vp]
        lib.rans_encoder_reset.argtypes = [vp]
        lib.rans_encoder_encode_with_indexes.argtypes = [
            vp, i32p, i32p, i64, i32p, i32, i32p, i32p]
        lib.rans_encoder_flush.argtypes = [vp]
        lib.rans_encoder_flush.restype = i64
        lib.rans_encoder_get_bytes.argtypes = [vp]
        lib.rans_encoder_get_bytes.restype = u8p
        lib.rans_decoder_new.restype = vp
        lib.rans_decoder_delete.argtypes = [vp]
        lib.rans_decoder_set_stream.argtypes = [vp, u8p, i64]
        lib.rans_decoder_set_cdf.argtypes = [vp, i32p, i32, i32, i32p, i32p]
        lib.rans_decoder_decode_stream.argtypes = [
            vp, i32p, i64, i32p, i32, i32p, i32p, i32p]
        lib.rans_decoder_decode_stream_only_indexes.argtypes = [
            vp, i32p, i64, i32p]
        lib.pmf_to_quantized_cdf.argtypes = [
            ctypes.POINTER(ctypes.c_float), i32, i32,
            ctypes.POINTER(ctypes.c_uint32)]
        lib.pmf_to_quantized_cdf.restype = i32
        _LIB = lib
    return _LIB


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.int32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class _Table:
    """A CDF table as the C calls take it: a 2-D int32 matrix (ragged rows
    zero-padded), per-row sizes and offsets, checked against each other."""

    def __init__(self, cdfs, cdf_sizes, offsets):
        if isinstance(cdfs, np.ndarray) and cdfs.ndim == 2:
            mat = _i32(cdfs)
        else:
            rows = [np.asarray(r, dtype=np.int32) for r in cdfs]
            mat = np.zeros((len(rows), max(len(r) for r in rows)), np.int32)
            for i, r in enumerate(rows):
                mat[i, :len(r)] = r
        self.mat = mat
        self.sizes = _i32(cdf_sizes).ravel()
        self.offsets = _i32(offsets).ravel()
        if not (self.sizes.size == self.offsets.size == mat.shape[0]):
            raise ValueError(f"{mat.shape[0]} CDF rows, {self.sizes.size} "
                             f"sizes, {self.offsets.size} offsets")
        if self.sizes.size and not (2 <= self.sizes.min()
                                    and self.sizes.max() <= mat.shape[1]):
            raise ValueError("a CDF size lies outside its row")

    def indexes(self, indexes) -> np.ndarray:
        """`indexes` as a flat int32 array, each a row of this table."""
        idx = _i32(indexes).ravel()
        if idx.size and not (0 <= idx.min() and idx.max() < self.sizes.size):
            raise ValueError(f"CDF index outside [0, {self.sizes.size})")
        return idx


class BufferedRansEncoder:
    """Accumulates symbols across calls; flush() emits one reverse-coded
    stream (the reference's buffered encoder)."""

    def __init__(self):
        # the library stays loaded while a handle lives (interpreter exit
        # clears module globals before the last __del__)
        self._lib = _lib()
        self._h = self._lib.rans_encoder_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rans_encoder_delete(self._h)
            self._h = None

    def encode_with_indexes(self, symbols, indexes, cdfs, cdf_sizes, offsets):
        table = _Table(cdfs, cdf_sizes, offsets)
        symbols = _i32(symbols).ravel()
        indexes = table.indexes(indexes)
        if symbols.size != indexes.size:
            raise ValueError(f"{symbols.size} symbols, {indexes.size} indexes")
        self._lib.rans_encoder_encode_with_indexes(
            self._h, _ptr(symbols), _ptr(indexes), symbols.size,
            _ptr(table.mat), table.mat.shape[1], _ptr(table.sizes),
            _ptr(table.offsets))

    def flush(self) -> bytes:
        n = self._lib.rans_encoder_flush(self._h)
        return ctypes.string_at(self._lib.rans_encoder_get_bytes(self._h), n)

    def reset(self):
        self._lib.rans_encoder_reset(self._h)


class RansEncoder(BufferedRansEncoder):
    """One-shot variant: encode_with_indexes returns the stream bytes."""

    def encode_with_indexes(self, symbols, indexes, cdfs, cdf_sizes, offsets):
        self.reset()
        super().encode_with_indexes(symbols, indexes, cdfs, cdf_sizes, offsets)
        return self.flush()


class RansDecoder:
    def __init__(self):
        self._lib = _lib()  # see BufferedRansEncoder
        self._h = self._lib.rans_decoder_new()
        self._stored = None  # the table of set_cdf

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rans_decoder_delete(self._h)
            self._h = None

    def set_stream(self, stream: bytes):
        buf = np.frombuffer(stream, dtype=np.uint8)
        self._lib.rans_decoder_set_stream(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.size)

    def set_cdf(self, cdfs, cdf_sizes, offsets):
        table = _Table(cdfs, cdf_sizes, offsets)
        self._lib.rans_decoder_set_cdf(
            self._h, _ptr(table.mat), table.mat.shape[1], table.mat.shape[0],
            _ptr(table.sizes), _ptr(table.offsets))
        self._stored = table

    def decode_stream(self, indexes, cdfs, cdf_sizes, offsets) -> np.ndarray:
        table = _Table(cdfs, cdf_sizes, offsets)
        indexes = table.indexes(indexes)
        out = np.empty(indexes.size, dtype=np.int32)
        self._lib.rans_decoder_decode_stream(
            self._h, _ptr(indexes), indexes.size, _ptr(table.mat),
            table.mat.shape[1], _ptr(table.sizes), _ptr(table.offsets),
            _ptr(out))
        return out

    def decode_with_indexes(self, stream, indexes, cdfs, cdf_sizes,
                            offsets) -> np.ndarray:
        self.set_stream(stream)
        return self.decode_stream(indexes, cdfs, cdf_sizes, offsets)

    def decode_stream_only_indexes(self, indexes) -> np.ndarray:
        if self._stored is None:
            raise RuntimeError("decode_stream_only_indexes before set_cdf")
        indexes = self._stored.indexes(indexes)
        out = np.empty(indexes.size, dtype=np.int32)
        self._lib.rans_decoder_decode_stream_only_indexes(
            self._h, _ptr(indexes), indexes.size, _ptr(out))
        return out


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    """Quantise a float PMF to an integer CDF that sums to 2^precision, each
    symbol with a frequency of at least 1."""
    pmf = np.ascontiguousarray(np.asarray(pmf), dtype=np.float32)
    out = np.empty(pmf.size + 1, dtype=np.uint32)
    rc = _lib().pmf_to_quantized_cdf(
        pmf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pmf.size,
        precision, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if rc != 0:
        raise ValueError("pmf_to_quantized_cdf: degenerate pmf")
    return out.astype(np.int32)
