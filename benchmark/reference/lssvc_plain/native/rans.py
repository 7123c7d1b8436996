"""Plain Python rANS decoder and CDF quantizer: the algorithm of the
program's `csrc/lssvc_rans.cpp` (the reference coder's stream format:
64-bit rANS state, 32-bit words, 16-bit CDFs, a 4-bit bypass escape for
values outside a CDF's range), written out in Python so that the
benchmark's reference reads the program's bitstreams with no code of the
program.  The encoder classes exist for the copied coder bundles' sake and
refuse to encode: the reference never writes a stream.
"""

from __future__ import annotations

from bisect import bisect_right

import numpy as np

RANS_L = 1 << 31
PROB_BITS = 16
PROB_MASK = (1 << PROB_BITS) - 1
BYPASS_BITS = 4
MAX_BYPASS = (1 << BYPASS_BITS) - 1
WORD_MASK = (1 << 32) - 1


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    """The C++ `pmf_to_quantized_cdf`: each float32 pmf value times
    2^precision rounded half away from zero, rescaled to sum 2^precision,
    and every zero-frequency slot repaired by stealing one count from the
    smallest frequency above 1."""
    pmf = np.asarray(pmf, dtype=np.float32).ravel()
    scaled = pmf * np.float32(1 << precision)  # exact: a power of two
    out = [0]
    for v in scaled.tolist():
        r = np.floor(abs(v) + 0.5)
        r = r if v >= 0 else -r
        out.append(int(r) if r > 0 else 0)
    n = len(out)
    total = sum(out)
    if total == 0:
        raise ValueError("pmf_to_quantized_cdf: degenerate pmf")
    out = [((1 << precision) * v) // total for v in out]
    acc = 0
    for i in range(n):
        acc += out[i]
        out[i] = acc
    out[n - 1] = 1 << precision
    for i in range(n - 1):
        if out[i] == out[i + 1]:
            best_freq, best_steal = None, -1
            for j in range(n - 1):
                freq = out[j + 1] - out[j]
                if freq > 1 and (best_freq is None or freq < best_freq):
                    best_freq, best_steal = freq, j
            if best_steal == -1:
                raise ValueError("pmf_to_quantized_cdf: cannot repair")
            if best_steal < i:
                for j in range(best_steal + 1, i + 1):
                    out[j] -= 1
            else:
                for j in range(i + 1, best_steal + 1):
                    out[j] += 1
    return np.asarray(out, dtype=np.int32)


class RansDecoder:
    """Decodes one stream, symbol by symbol, as the C++ `Decoder` does."""

    def __init__(self):
        self.words: list[int] = []
        self.pos = 0
        self.x = 0

    def set_stream(self, stream: bytes):
        n = len(stream)
        padded = bytes(stream) + bytes(((n + 3) // 4 + 2) * 4 - n)
        self.words = np.frombuffer(padded, dtype="<u4").tolist()
        self.x = self.words[0] | (self.words[1] << 32)
        self.pos = 2

    def _next_word(self) -> int:
        if self.pos < len(self.words):
            w = self.words[self.pos]
            self.pos += 1
            return w
        return 0

    def _get_bits(self, nbits: int) -> int:
        val = self.x & ((1 << nbits) - 1)
        self.x >>= nbits
        if self.x < RANS_L:
            self.x = ((self.x << 32) | self._next_word())
        return val

    def decode_stream(self, indexes, cdfs, cdf_sizes, offsets) -> np.ndarray:
        cdfs = np.asarray(cdfs, dtype=np.int64)
        sizes = np.asarray(cdf_sizes, dtype=np.int64).ravel().tolist()
        offs = np.asarray(offsets, dtype=np.int64).ravel().tolist()
        rows = [cdfs[i, :sizes[i]].tolist() for i in range(len(sizes))]
        idx = np.asarray(indexes, dtype=np.int64).ravel().tolist()
        out = [0] * len(idx)
        x, words, pos, nwords = self.x, self.words, self.pos, len(self.words)
        for k, r in enumerate(idx):
            cdf = rows[r]
            max_value = sizes[r] - 2
            cum = x & PROB_MASK
            s = bisect_right(cdf, cum) - 1
            start = cdf[s]
            x = (cdf[s + 1] - start) * (x >> PROB_BITS) + cum - start
            if x < RANS_L:
                x = (x << 32) | (words[pos] if pos < nwords else 0)
                pos += 1
            value = s
            if value == max_value:
                self.x, self.pos = x, pos
                val = self._get_bits(BYPASS_BITS)
                n_bypass = val
                while val == MAX_BYPASS:
                    val = self._get_bits(BYPASS_BITS)
                    n_bypass += val
                raw = 0
                for j in range(n_bypass):
                    d = self._get_bits(BYPASS_BITS)
                    if j * BYPASS_BITS < 64:
                        raw |= d << (j * BYPASS_BITS)
                raw &= (1 << 64) - 1
                value = raw >> 1
                value = -value - 1 if raw & 1 else value + max_value
                x, pos = self.x, self.pos
            out[k] = value + offs[r]
        self.x, self.pos = x, pos
        return np.asarray(out, dtype=np.int64)

    def decode_with_indexes(self, stream, indexes, cdfs, cdf_sizes, offsets):
        self.set_stream(stream)
        return self.decode_stream(indexes, cdfs, cdf_sizes, offsets)


class BufferedRansEncoder:
    """Present so the copied coder bundles build; the reference never
    encodes."""

    def encode_with_indexes(self, *args, **kwargs):
        raise RuntimeError("the reference does not encode streams")

    def flush(self):
        raise RuntimeError("the reference does not encode streams")

    def reset(self):
        pass


class RansEncoder(BufferedRansEncoder):
    pass
