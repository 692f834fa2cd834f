"""Binary GBWT reader: haplotype import from vg's native index format.

The reference pipeline stores haplotypes in a GBWT produced by ``vg index
-G chrom.gbwt -v VCF`` and queries it through ``vg find -H``
(reference ``constructVG.py:327-340``, ``extract_regions.py:180``).  This
module reads those ``.gbwt`` files directly, so graphs exported from vg
*without* GFA 1.1 W lines still import with their haplotype panel.

Format notes (reverse-engineered from vg-produced fixtures; layouts
verified byte-exact against ``tests/test_data/expected_results/
expected.gbwt`` and the tutorial indexes):

* optional libvgio type-tagged framing: groups of ``varint count``
  messages, each ``varint length + payload``; the first message of a
  group is the ASCII type tag (``GBWT``), remaining messages are payload
  chunks.  Bare sdsl streams (``gbwt`` CLI output) are accepted too.
* GBWT header: ``uint32 tag (0x6b376b37), uint32 version, uint64
  sequences, size, offset, alphabet_size, flags``.
* BWT: a RecordArray — ``uint64 records``, an ``sdsl::sd_vector`` of
  record start offsets (with its two serialized mcl select supports),
  then the raw record bytes.  Each record: ByteCode outdegree,
  outdegree x (ByteCode successor delta, ByteCode offset), then
  run-length encoded body (``Run`` encoding keyed by outdegree).
* Metadata (flag 0x2): header ``uint32 tag (0x6b375e7a), uint32
  version, uint64 samples, haplotypes, contigs, flags`` followed by
  path names (4 x uint32 each: sample, contig, phase, count) and
  sample/contig name dictionaries.  The DASamples section between the
  BWT and the metadata is not needed for path extraction and is skipped
  by scanning for the metadata tag with structural validation.

Sequence extraction is the textbook LF walk: sequence ``i`` starts at
offset ``i`` of the endmarker record; in a bidirectional index sequence
``2j`` is the forward orientation of path ``j``.
"""

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from grafimo_tpu_torch.errors import GraphError

GBWT_TAG = 0x6B376B37
METADATA_TAG = 0x6B375E7A
FLAG_BIDIRECTIONAL = 0x1
FLAG_METADATA = 0x2
META_FLAG_PATH_NAMES = 0x1
META_FLAG_SAMPLE_NAMES = 0x2
META_FLAG_CONTIG_NAMES = 0x4


# ---------------------------------------------------------------------------
# sdsl primitives
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.d = data
        self.p = pos

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.d, self.p)[0]
        self.p += 8
        return v

    def u8(self) -> int:
        v = self.d[self.p]
        self.p += 1
        return v

    def raw(self, n: int) -> bytes:
        v = self.d[self.p : self.p + n]
        if len(v) != n:
            raise GraphError("gbwt: unexpected end of file")
        self.p += n
        return v

    # sdsl::int_vector<0>: uint64 bits, uint8 width, padded 64-bit words
    def iv0(self) -> Tuple[np.ndarray, int]:
        bits = self.u64()
        width = self.u8()
        nw = (bits + 63) // 64
        words = np.frombuffer(self.raw(8 * nw), dtype="<u8")
        if width == 0:
            return np.zeros(0, dtype=np.int64), 0
        n = bits // width
        return _unpack_iv(words, width, n), width

    # sdsl::bit_vector (int_vector<1>, fixed width: no width byte)
    def bv(self) -> Tuple[np.ndarray, int]:
        bits = self.u64()
        nw = (bits + 63) // 64
        words = np.frombuffer(self.raw(8 * nw), dtype="<u8")
        return words, bits

    def skip_iv0(self) -> None:
        bits = self.u64()
        self.p += 1 + 8 * ((bits + 63) // 64)

    def skip_bv(self) -> None:
        bits = self.u64()
        self.p += 8 * ((bits + 63) // 64)

    # sdsl::select_support_mcl serialization
    def skip_select(self) -> None:
        arg_cnt = self.u64()
        if arg_cnt:
            sb = (arg_cnt + 4095) >> 12
            self.skip_iv0()  # superblock
            self.skip_bv()  # mini_or_long indicator
            for _ in range(sb):
                self.skip_iv0()  # mini/long block

    # sdsl::sd_vector<> -> positions of set bits
    def sd_vector(self) -> Tuple[np.ndarray, int]:
        m_size = self.u64()
        wl = self.u8()
        low, low_w = self.iv0()
        high_words, high_bits = self.bv()
        self.skip_select()  # high_1_select
        self.skip_select()  # high_0_select
        ones = _word_bit_positions(high_words, high_bits)
        n = len(ones)
        if low_w:
            vals = ((ones - np.arange(n)) << wl) | low[:n].astype(np.int64)
        else:
            vals = ones - np.arange(n)
        return vals.astype(np.int64), m_size


def _unpack_iv(words: np.ndarray, width: int, n: int) -> np.ndarray:
    """Unpack n little-endian `width`-bit integers from 64-bit words."""
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    bitpos = np.arange(n, dtype=np.int64) * width
    wi = bitpos >> 6
    off = bitpos & 63
    lo = words[wi] >> off.astype(np.uint64)
    spill = off + width > 64
    hi = np.zeros(n, dtype=np.uint64)
    if spill.any():
        hi[spill] = words[wi[spill] + 1] << (64 - off[spill]).astype(
            np.uint64
        )
    vals = (lo | hi) & np.uint64((1 << width) - 1 if width < 64 else ~0)
    return vals.astype(np.int64)


def _word_bit_positions(words: np.ndarray, nbits: int) -> np.ndarray:
    """Positions of set bits in a little-endian packed word array."""
    if len(words) == 0:
        return np.zeros(0, dtype=np.int64)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")[:nbits]
    return np.flatnonzero(bits).astype(np.int64)


def _bytecode(d: bytes, p: int) -> Tuple[int, int]:
    """gbwt ByteCode varint (7-bit little-endian groups)."""
    v = 0
    s = 0
    while True:
        c = d[p]
        p += 1
        v |= (c & 0x7F) << s
        if not c & 0x80:
            return v, p
        s += 7


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------


@dataclass
class GbwtPathName:
    sample: int
    contig: int
    phase: int
    count: int


@dataclass
class GbwtIndex:
    version: int
    sequences: int
    size: int
    offset: int
    alphabet_size: int
    flags: int
    # record i covers gbwt-node (0 if i == 0 else i + offset - ... ); see
    # _record_of. Each record: (edges [(succ, off)], run_vals, run_starts,
    # counts_before) decoded lazily.
    _rec_bytes: List[bytes] = field(default_factory=list, repr=False)
    _rec_cache: Dict[int, tuple] = field(default_factory=dict, repr=False)
    path_names: List[GbwtPathName] = field(default_factory=list)
    sample_names: List[str] = field(default_factory=list)
    contig_names: List[str] = field(default_factory=list)
    haplotype_count: Optional[int] = None

    @property
    def bidirectional(self) -> bool:
        return bool(self.flags & FLAG_BIDIRECTIONAL)

    @property
    def n_paths(self) -> int:
        return self.sequences // 2 if self.bidirectional else self.sequences

    # -- BWT navigation -----------------------------------------------------
    def _record(self, node: int):
        idx = 0 if node == 0 else node - self.offset
        rec = self._rec_cache.get(idx)
        if rec is not None:
            return rec
        body = self._rec_bytes[idx]
        if not body:
            rec = ([], None, None, None)
            self._rec_cache[idx] = rec
            return rec
        p = 0
        outdegree, p = _bytecode(body, p)
        edges = []
        prev = 0
        for _ in range(outdegree):
            delta, p = _bytecode(body, p)
            prev += delta
            off, p = _bytecode(body, p)
            edges.append((prev, off))
        vals: List[int] = []
        lens: List[int] = []
        if outdegree:
            run_continues = 256 // outdegree if outdegree < 256 else 0
            while p < len(body):
                if run_continues == 0:
                    v, p = _bytecode(body, p)
                    ln, p = _bytecode(body, p)
                    ln += 1
                else:
                    c = body[p]
                    p += 1
                    v = c % outdegree
                    ln = c // outdegree + 1
                    if ln == run_continues:
                        ext, p = _bytecode(body, p)
                        ln += ext
                vals.append(v)
                lens.append(ln)
        run_vals = np.array(vals, dtype=np.int64)
        run_lens = np.array(lens, dtype=np.int64)
        run_starts = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(run_lens, out=run_starts[1:])
        # counts_before[r, v]: occurrences of edge-rank v before run r
        counts = np.zeros((len(vals) + 1, outdegree), dtype=np.int64)
        if len(vals):
            onehot = np.zeros((len(vals), outdegree), dtype=np.int64)
            onehot[np.arange(len(vals)), run_vals] = run_lens
            np.cumsum(onehot, axis=0, out=counts[1:])
        rec = (edges, run_vals, run_starts, counts)
        self._rec_cache[idx] = rec
        return rec

    def _lf(self, node: int, pos: int) -> Tuple[int, int]:
        edges, run_vals, run_starts, counts = self._record(node)
        if run_vals is None:
            raise GraphError(f"gbwt: empty record for node {node}")
        ri = int(np.searchsorted(run_starts, pos, side="right")) - 1
        v = int(run_vals[ri])
        rank = int(counts[ri, v]) + (pos - int(run_starts[ri]))
        succ, base = edges[v]
        return succ, base + rank

    def extract(self, sequence: int) -> List[int]:
        """Oriented gbwt-node walk of one sequence (endmarker excluded)."""
        node, pos = self._lf(0, sequence)
        out: List[int] = []
        guard = self.size + 1
        while node != 0:
            out.append(node)
            node, pos = self._lf(node, pos)
            if len(out) > guard:
                raise GraphError("gbwt: walk exceeds index size (corrupt?)")
        return out

    def path_walks(self) -> List[Tuple[int, List[int]]]:
        """(path_id, oriented node walk) for every logical path (the
        forward sequence of each path in a bidirectional index)."""
        step = 2 if self.bidirectional else 1
        return [
            (j, self.extract(j * step)) for j in range(self.n_paths)
        ]


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------


def _unwrap_vgio(data: bytes) -> bytes:
    """Strip libvgio type-tagged framing if present; concatenate payload
    chunks of every GBWT-tagged group."""
    if len(data) >= 12 and struct.unpack_from("<I", data, 0)[0] == GBWT_TAG:
        return data  # bare sdsl stream
    chunks = []
    p = 0
    try:
        while p < len(data):
            cnt, p = _bytecode(data, p)
            if cnt < 1:
                raise ValueError
            ln, p = _bytecode(data, p)
            tag = data[p : p + ln]
            p += ln
            if tag != b"GBWT":
                raise ValueError
            for _ in range(cnt - 1):
                ln, p = _bytecode(data, p)
                chunks.append(data[p : p + ln])
                p += ln
    except (ValueError, IndexError):
        raise GraphError(
            "not a GBWT file (neither bare sdsl nor vg type-tagged)"
        )
    return b"".join(chunks)


def _parse_dictionary(r: _Reader, n: int) -> List[str]:
    """gbwt::Dictionary -> list of names (offsets, sorted_ids, data)."""
    offsets, _w = r.iv0()
    r.skip_iv0()  # sorted_ids
    dlen = r.u64()
    data = r.raw(dlen)
    names = []
    for i in range(n):
        s = int(offsets[i])
        e = int(offsets[i + 1]) if i + 1 < len(offsets) else dlen
        names.append(data[s:e].decode("utf-8", errors="replace"))
    return names


def _parse_metadata(r: _Reader, idx: GbwtIndex) -> None:
    tag, version = struct.unpack_from("<II", r.d, r.p)
    r.p += 8
    if tag != METADATA_TAG:
        raise GraphError("gbwt: bad metadata tag")
    samples = r.u64()
    haplotypes = r.u64()
    contigs = r.u64()
    flags = r.u64()
    idx.haplotype_count = haplotypes
    if flags & META_FLAG_PATH_NAMES:
        n = r.u64()
        for _ in range(n):
            s, c, p_, cnt = struct.unpack_from("<IIII", r.d, r.p)
            r.p += 16
            idx.path_names.append(GbwtPathName(s, c, p_, cnt))
    if flags & META_FLAG_SAMPLE_NAMES:
        idx.sample_names = _parse_dictionary(r, samples)
    if flags & META_FLAG_CONTIG_NAMES:
        idx.contig_names = _parse_dictionary(r, contigs)


def _find_metadata(data: bytes, start: int) -> Optional[int]:
    """Scan for a structurally valid metadata header (the DASamples
    section in between has no content we need)."""
    pos = start
    while True:
        pos = data.find(struct.pack("<I", METADATA_TAG), pos)
        if pos < 0:
            return None
        if pos + 40 <= len(data):
            ver, = struct.unpack_from("<I", data, pos + 4)
            s, h, c, fl = struct.unpack_from("<QQQQ", data, pos + 8)
            if 1 <= ver <= 2 and s < 1 << 40 and h < 1 << 40 \
                    and c < 1 << 40 and fl < 16:
                return pos
        pos += 1


def read_gbwt(path: str) -> GbwtIndex:
    """Parse a binary ``.gbwt`` file (vg type-tagged or bare sdsl)."""
    with open(path, "rb") as f:
        data = _unwrap_vgio(f.read())
    if len(data) < 48:
        raise GraphError("gbwt: file too short")
    r = _Reader(data)
    tag, version = struct.unpack_from("<II", data, 0)
    r.p = 8
    if tag != GBWT_TAG:
        raise GraphError("gbwt: bad header tag")
    if not 1 <= version <= 5:
        raise GraphError(f"gbwt: unsupported version {version}")
    sequences = r.u64()
    size = r.u64()
    offset = r.u64()
    alphabet = r.u64()
    flags = r.u64()
    if version >= 5:
        # v5 adds a Tags StringArray between header and BWT:
        # int_vector<0> offsets + length-prefixed data (best effort)
        r.skip_iv0()
        dlen = r.u64()
        r.p += dlen
    idx = GbwtIndex(
        version=version, sequences=sequences, size=size, offset=offset,
        alphabet_size=alphabet, flags=flags,
    )
    # RecordArray
    records = r.u64()
    starts, m_size = r.sd_vector()
    data_len = m_size
    body = r.raw(data_len)
    bounds = list(starts) + [data_len]
    if len(starts) != records:
        raise GraphError("gbwt: record index/count mismatch")
    idx._rec_bytes = [
        body[int(bounds[i]) : int(bounds[i + 1])] for i in range(records)
    ]
    if flags & FLAG_METADATA:
        mpos = _find_metadata(data, r.p)
        if mpos is not None:
            r.p = mpos
            _parse_metadata(r, idx)
    return idx


# ---------------------------------------------------------------------------
# Integration: GBWT walks -> GFA-style walk tuples
# ---------------------------------------------------------------------------


def gbwt_walks(
    path: str, contig: Optional[str] = None
) -> List[Tuple[str, int, str, List[str]]]:
    """Read a ``.gbwt`` and return GFA-1.1-W-line-style walk tuples
    ``(sample_name, hap_index, contig_name, [node names])`` — the format
    :func:`grafimo_tpu.graph.gfa.gfa_to_sitegraph` consumes.

    Reverse-oriented steps are rejected (VCF-derived vg graphs are
    forward-only, matching the GFA importer's contract).
    """
    idx = read_gbwt(path)
    out = []
    for j, walk in idx.path_walks():
        if any(n & 1 for n in walk):
            raise GraphError(
                "gbwt: reverse-oriented walk steps are not supported "
                "(non-VCF-derived graph?)"
            )
        nodes = [str(n >> 1) for n in walk]
        if idx.path_names and j < len(idx.path_names):
            pn = idx.path_names[j]
            sample = (
                idx.sample_names[pn.sample]
                if pn.sample < len(idx.sample_names)
                else str(pn.sample)
            )
            cname = (
                idx.contig_names[pn.contig]
                if pn.contig < len(idx.contig_names)
                else str(pn.contig)
            )
            phase = pn.phase
        else:
            sample, cname, phase = str(j), contig or "0", 0
        if contig is not None and cname != contig and len(
            set(idx.contig_names)
        ) > 1:
            continue
        out.append((sample, phase, contig if contig is not None else cname,
                    nodes))
    return out
