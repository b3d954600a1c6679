"""LSB-first bit IO + length-limited canonical Huffman coding.

The entropy layer under the KTX2 BasisLZ (ETC1S) texture path
(scene/basis_lz.py). The scheme mirrors the basis_universal compressed-stream
design (the reference consumes it through libktx — texture_loader.hpp:23-70):

- bits are packed LSB-first into bytes (first bit written = bit 0 of byte 0);
- Huffman tables are canonical (codes assigned in (length, symbol) order) with
  a maximum code length of 16, and are themselves serialized with a
  Deflate-style code-length code: symbol lengths are run-length coded with
  four run symbols (small/big zero runs, small/big repeats), and the
  code-length code's 3-bit lengths are sent in a fixed "most useful first"
  order so trailing zeros can be dropped.

Numeric constants (run-code values/ranges, the sorted code-length order, the
14-bit symbol-count field) follow the basis_universal scheme as documented in
its public transcoder; with no test vectors or spec text available in this
environment (zero egress — docs/ROADMAP.md), bit-compatibility with foreign
streams is UNVERIFIED. Encoder and decoder here are independent
implementations verified against each other (tests/test_bitstream.py), and
every format constant lives in this module so a future vector source can
correct them in one place.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

MAX_CODE_SIZE = 16
MAX_SYMS_LOG2 = 14
MAX_SYMS = 1 << MAX_SYMS_LOG2

# Code-length-code run symbols (Deflate-like, basisu values).
SMALL_ZERO_RUN = 17  # 3..10 zeros, 3 extra bits
BIG_ZERO_RUN = 18  # 11..138 zeros, 7 extra bits
SMALL_REPEAT = 19  # repeat prev nonzero len 3..6 times, 2 extra bits
BIG_REPEAT = 20  # repeat prev nonzero len 7..134 times, 7 extra bits
SMALL_ZERO_RUN_MIN, SMALL_ZERO_RUN_EXTRA = 3, 3
BIG_ZERO_RUN_MIN, BIG_ZERO_RUN_EXTRA = 11, 7
SMALL_REPEAT_MIN, SMALL_REPEAT_EXTRA = 3, 2
BIG_REPEAT_MIN, BIG_REPEAT_EXTRA = 7, 7
TOTAL_CODELENGTH_CODES = 21
# Order in which the 3-bit lengths of the code-length code are transmitted
# (run codes + plausible lengths first, so unused tail entries cost nothing).
SORTED_CODELENGTH_ORDER = (
    SMALL_ZERO_RUN, BIG_ZERO_RUN, SMALL_REPEAT, BIG_REPEAT,
    0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15, 16,
)


class BitWriter:
    """LSB-first bit packer."""

    def __init__(self) -> None:
        self._acc = 0
        self._n = 0
        self._out = bytearray()

    def put_bits(self, value: int, num: int) -> None:
        if num < 0 or value < 0 or (num < 63 and value >> num):
            raise ValueError(f"put_bits({value}, {num}) out of range")
        self._acc |= value << self._n
        self._n += num
        while self._n >= 8:
            self._out.append(self._acc & 0xFF)
            self._acc >>= 8
            self._n -= 8

    def put_vlq(self, value: int, chunk: int = 8) -> None:
        """Variable-length quantity: ``chunk`` data bits + 1 continuation bit."""
        while True:
            lo = value & ((1 << chunk) - 1)
            value >>= chunk
            self.put_bits(lo, chunk)
            self.put_bits(1 if value else 0, 1)
            if not value:
                return

    def finish(self) -> bytes:
        if self._n:
            self._out.append(self._acc & 0xFF)
            self._acc = 0
            self._n = 0
        return bytes(self._out)


class BitReader:
    """LSB-first bit reader over a byte string."""

    def __init__(self, data: bytes, bit_offset: int = 0) -> None:
        self._data = data
        self._pos = bit_offset

    @property
    def bit_position(self) -> int:
        return self._pos

    def get_bits(self, num: int) -> int:
        if num == 0:
            return 0
        end = self._pos + num
        if end > 8 * len(self._data):
            raise ValueError("bitstream truncated")
        first = self._pos >> 3
        last = (end - 1) >> 3
        chunk = int.from_bytes(self._data[first : last + 1], "little")
        out = (chunk >> (self._pos & 7)) & ((1 << num) - 1)
        self._pos = end
        return out

    def get_vlq(self, chunk: int = 8) -> int:
        value = 0
        shift = 0
        while True:
            value |= self.get_bits(chunk) << shift
            shift += chunk
            if not self.get_bits(1):
                return value


def _limited_code_lengths(freqs: Sequence[int], max_len: int) -> List[int]:
    """Huffman code lengths, limited to ``max_len`` (heap + overflow rebalance)."""
    syms = [i for i, f in enumerate(freqs) if f > 0]
    if not syms:
        return [0] * len(freqs)
    if len(syms) == 1:
        lens = [0] * len(freqs)
        lens[syms[0]] = 1
        return lens
    import heapq

    heap: List[Tuple[int, int, Tuple[int, ...]]] = [
        (freqs[s], s, (s,)) for s in syms
    ]
    heapq.heapify(heap)
    depth: Dict[int, int] = {s: 0 for s in syms}
    uid = len(freqs)
    while len(heap) > 1:
        fa, _, sa = heapq.heappop(heap)
        fb, _, sb = heapq.heappop(heap)
        for s in sa + sb:
            depth[s] += 1
        uid += 1
        heapq.heappush(heap, (fa + fb, uid, sa + sb))
    lens = [0] * len(freqs)
    for s, d in depth.items():
        lens[s] = d
    # Length-limit: repeatedly move an overlong leaf up by pairing it under the
    # deepest leaf with length < max_len (standard Kraft rebalance; slightly
    # suboptimal, always valid).
    while max(lens) > max_len:
        over = max(range(len(lens)), key=lambda i: lens[i])
        candidates = [i for i in range(len(lens)) if 0 < lens[i] < max_len]
        host = max(candidates, key=lambda i: lens[i])
        lens[over] = lens[host] + 1
        lens[host] += 1
    return lens


def _canonical_codes(lens: Sequence[int]) -> List[int]:
    """Canonical code values; codes are emitted MSB-first into the LSB-first
    bitstream (i.e. bit-reversed), so a reader can walk bits as they arrive."""
    pairs = sorted((l, s) for s, l in enumerate(lens) if l)
    codes = [0] * len(lens)
    code = 0
    prev_len = 0
    for l, s in pairs:
        code <<= l - prev_len
        prev_len = l
        codes[s] = code
        code += 1
    return codes


def _reverse_bits(v: int, n: int) -> int:
    out = 0
    for _ in range(n):
        out = (out << 1) | (v & 1)
        v >>= 1
    return out


class HuffmanTable:
    """Canonical Huffman codec for one symbol alphabet."""

    def __init__(self, lens: Sequence[int]) -> None:
        if len(lens) > MAX_SYMS:
            raise ValueError("alphabet too large")
        self.lens = list(lens)
        self.codes = _canonical_codes(lens)
        # Decode map: (reversed code bits, length) -> symbol.
        self._dec: Dict[Tuple[int, int], int] = {}
        for s, l in enumerate(self.lens):
            if l:
                self._dec[(_reverse_bits(self.codes[s], l), l)] = s
        self._min_len = min((l for l in self.lens if l), default=0)
        self._max_len = max(self.lens, default=0)

    @classmethod
    def from_frequencies(cls, freqs: Sequence[int]) -> "HuffmanTable":
        return cls(_limited_code_lengths(freqs, MAX_CODE_SIZE))

    @classmethod
    def from_symbols(cls, symbols: Sequence[int], alphabet: int) -> "HuffmanTable":
        freqs = [0] * alphabet
        for s in symbols:
            freqs[s] += 1
        return cls.from_frequencies(freqs)

    def encode(self, bw: BitWriter, symbol: int) -> None:
        l = self.lens[symbol]
        if not l:
            raise ValueError(f"symbol {symbol} has no code")
        bw.put_bits(_reverse_bits(self.codes[symbol], l), l)

    def decode(self, br: BitReader) -> int:
        acc = 0
        for l in range(1, self._max_len + 1):
            acc |= br.get_bits(1) << (l - 1)
            if l < self._min_len:
                continue
            sym = self._dec.get((acc, l))
            if sym is not None:
                return sym
        raise ValueError("invalid Huffman code in stream")


def _rle_code_lengths(lens: Sequence[int]) -> List[Tuple[int, int]]:
    """Symbol lengths -> (code, extra-bits value) pairs with zero/repeat runs.

    Extra-bits value is -1 for plain length codes (no extra bits follow)."""
    out: List[Tuple[int, int]] = []
    i = 0
    n = len(lens)
    while i < n:
        l = lens[i]
        run = 1
        while i + run < n and lens[i + run] == l:
            run += 1
        i += run
        if l == 0:
            while run >= BIG_ZERO_RUN_MIN:
                take = min(run, BIG_ZERO_RUN_MIN + (1 << BIG_ZERO_RUN_EXTRA) - 1)
                out.append((BIG_ZERO_RUN, take - BIG_ZERO_RUN_MIN))
                run -= take
            if run >= SMALL_ZERO_RUN_MIN:
                out.append((SMALL_ZERO_RUN, run - SMALL_ZERO_RUN_MIN))
                run = 0
            out.extend([(0, -1)] * run)
        else:
            out.append((l, -1))
            run -= 1
            while run >= BIG_REPEAT_MIN:
                take = min(run, BIG_REPEAT_MIN + (1 << BIG_REPEAT_EXTRA) - 1)
                out.append((BIG_REPEAT, take - BIG_REPEAT_MIN))
                run -= take
            if run >= SMALL_REPEAT_MIN:
                out.append((SMALL_REPEAT, run - SMALL_REPEAT_MIN))
                run = 0
            out.extend([(l, -1)] * run)
    return out


_EXTRA = {
    SMALL_ZERO_RUN: (SMALL_ZERO_RUN_MIN, SMALL_ZERO_RUN_EXTRA),
    BIG_ZERO_RUN: (BIG_ZERO_RUN_MIN, BIG_ZERO_RUN_EXTRA),
    SMALL_REPEAT: (SMALL_REPEAT_MIN, SMALL_REPEAT_EXTRA),
    BIG_REPEAT: (BIG_REPEAT_MIN, BIG_REPEAT_EXTRA),
}


def write_huffman_table(bw: BitWriter, table: HuffmanTable) -> None:
    """Serialize a table: 14-bit used-symbol count, then the RLE'd lengths
    under a 21-symbol code-length code whose own 3-bit lengths are sent in
    SORTED_CODELENGTH_ORDER (trailing zeros dropped)."""
    lens = table.lens
    total_used = 0
    for s, l in enumerate(lens):
        if l:
            total_used = s + 1
    bw.put_bits(total_used, MAX_SYMS_LOG2)
    if not total_used:
        return
    rle = _rle_code_lengths(lens[:total_used])
    # The code-length code's lengths live in a fixed 3-bit field: limit to 7.
    cl_freqs = [0] * TOTAL_CODELENGTH_CODES
    for c, _ in rle:
        cl_freqs[c] += 1
    cl_table = HuffmanTable(_limited_code_lengths(cl_freqs, 7))
    num_sent = TOTAL_CODELENGTH_CODES
    while num_sent > 1 and not cl_table.lens[SORTED_CODELENGTH_ORDER[num_sent - 1]]:
        num_sent -= 1
    bw.put_bits(num_sent, 5)
    for i in range(num_sent):
        bw.put_bits(cl_table.lens[SORTED_CODELENGTH_ORDER[i]], 3)
    for code, extra in rle:
        cl_table.encode(bw, code)
        if extra >= 0:
            _, nbits = _EXTRA[code]
            bw.put_bits(extra, nbits)


def read_huffman_table(br: BitReader) -> HuffmanTable:
    total_used = br.get_bits(MAX_SYMS_LOG2)
    if not total_used:
        return HuffmanTable([])
    num_sent = br.get_bits(5)
    cl_lens = [0] * TOTAL_CODELENGTH_CODES
    for i in range(num_sent):
        cl_lens[SORTED_CODELENGTH_ORDER[i]] = br.get_bits(3)
    cl_table = HuffmanTable(cl_lens)
    lens: List[int] = []
    while len(lens) < total_used:
        c = cl_table.decode(br)
        if c <= MAX_CODE_SIZE:
            lens.append(c)
        elif c in (SMALL_ZERO_RUN, BIG_ZERO_RUN):
            base, nbits = _EXTRA[c]
            lens.extend([0] * (base + br.get_bits(nbits)))
        else:
            base, nbits = _EXTRA[c]
            if not lens or not lens[-1]:
                raise ValueError("repeat code with no previous nonzero length")
            lens.extend([lens[-1]] * (base + br.get_bits(nbits)))
    if len(lens) != total_used:
        raise ValueError("code-length stream overran the symbol count")
    return HuffmanTable(lens)
