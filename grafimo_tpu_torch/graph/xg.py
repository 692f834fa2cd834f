"""Native ``.xg`` (vg succinct graph index) import.

``.xg`` is the reference's actual on-disk input contract: findmotif
scans per-chromosome ``.xg``+``.gbwt`` directories through the vg
binary (``vg find -x chr.xg -H chr.gbwt``, reference
``extract_regions.py:180``, ``workflow.py:629``), and the shipped
findmotif tutorial provides ONLY those artifacts.  This module reads
the XG serialization directly, so a user holding exactly the
reference's tutorial inputs — and no vg — runs findmotif natively.

Format notes (reverse-engineered byte-exact against the in-tree vg
oracles ``tests/test_data/expected_results/expected.xg`` and the four
tutorial indexes, all XG file-format version 15; validated
differentially against the same graphs built from their FASTA+VCF
provenance):

* libvgio type-tagged framing: groups of ``varint count`` messages,
  each ``varint length + payload``; first message of a group is the
  ASCII tag ``XG``.
* payload header: ``htonl magic 0xF6F596A1`` (SerializableHandleGraph),
  ``htonl file_version``, then six little-endian ``uint64``:
  sequence length, node count, edge count, path count, min id, max id.
* node id vector (sdsl ``int_vector<>``, ids by rank — redundant with
  the per-record id field below, kept only as a cross-check).
* graph vector ``g_iv`` (``int_vector<>``) + record-start bit vector
  ``g_bv`` (+ rank/select supports): one record per node —
  ``[id, seq_start, seq_len, to_count, from_count, to_edges...,
  from_edges...]`` where each edge is one integer
  ``zigzag(delta) << 1 | flag`` with ``delta`` the g-offset of the
  other record minus this record's offset (flag observed 0 on all
  vg-construct graphs; a set flag marks an inversion edge, which this
  importer rejects).
* sequence ``s_iv`` (``int_vector<>``, code table A=0 T=1 C=2 G=3
  [N=4 at width 3]) + node-start bit vector ``s_bv`` (+ supports).
* path names: ``pn_iv`` (``int_vector<64>`` of chars, names framed as
  ``#name$``), a ``csa_wt<wt_huff>`` over that string (parsed
  structurally and skipped: wt size/sigma, tree bit vector + rank +
  two mcl selects, prefix-code tree of 22-byte nodes + 256x2 + 256x8
  lookup tables, SA/ISA sample ``int_vector<>``s, byte_alphabet),
  ``pn_bv`` name-start bit vector (+ supports), ``pi_iv`` path ids,
  and a repeated path count.
* per path an XGPath: ``uint64 min_handle``; handles as
  ``enc_vector<elias_delta, 128>`` (samples+pointers vector, delta
  bitstream; handle = g-record offset << 1 | is_reverse, stored
  relative to min_handle); node start offsets as ``rrr_vector<63>``
  (block classes at fixed width 6, per-block offsets of
  ``bitlen(C(63,k))`` bits in combinatorial-number-system order, LSB
  block bit first); one trailing flag byte.
* node→path membership vectors follow; not needed and not parsed.

Every section is validated structurally (record/edge counts, sequence
lengths, offsets-vs-handles consistency); any mismatch raises
``GraphError``, which ``workflows.load_graph_file`` converts into the
actionable vg-conversion message — i.e. the conversion path survives
only for genuinely unparsable files.
"""

import struct
from math import comb
from typing import Dict, List, Optional, Tuple

import numpy as np

from grafimo_tpu_torch.errors import GraphError
from grafimo_tpu_torch.graph.gbwt import (
    _bytecode,
    _Reader,
    _unpack_iv,
    _word_bit_positions,
)
from grafimo_tpu_torch.graph.gfa import tuples_to_sitegraph
from grafimo_tpu_torch.graph.sitegraph import SiteGraph

XG_MAGIC = 0xF6F596A1
_SEQ_CODES = "ATCGN"


# ---------------------------------------------------------------------------
# sdsl primitives on top of the GBWT reader
# ---------------------------------------------------------------------------


def _iv0(r: _Reader) -> np.ndarray:
    """sdsl ``int_vector<0>``: uint64 bit count, uint8 width, words."""
    bits = r.u64()
    width = r.u8()
    nw = (bits + 63) // 64
    words = np.frombuffer(r.raw(8 * nw), dtype="<u8")
    if width == 0:
        if bits:
            raise GraphError("xg: int_vector with zero width")
        return np.zeros(0, dtype=np.int64)
    if width == 64:
        return words[: bits // 64].astype(np.int64)
    return _unpack_iv(words, width, bits // width)


def _bv(r: _Reader) -> Tuple[np.ndarray, int]:
    """sdsl ``bit_vector`` -> (positions of set bits, size in bits)."""
    bits = r.u64()
    nw = (bits + 63) // 64
    words = np.frombuffer(r.raw(8 * nw), dtype="<u8")
    return _word_bit_positions(words, bits), bits


def _skip_rank(r: _Reader) -> None:
    """sdsl ``rank_support_v``: one ``int_vector<64>`` of basic blocks."""
    bits = r.u64()
    r.p += 8 * ((bits + 63) // 64)


def _skip_fixed_iv(r: _Reader) -> None:
    """Fixed-width ``int_vector<w>`` (no width byte), contents unused."""
    bits = r.u64()
    r.p += 8 * ((bits + 63) // 64)


class _BitStream:
    """LSB-first bit reader over little-endian uint64 words."""

    def __init__(self, words: np.ndarray, nbits: int):
        self.w = words
        self.n = nbits
        self.p = 0

    def take(self, n: int) -> int:
        p = self.p
        if p + n > self.n:
            raise GraphError("xg: bitstream overrun")
        self.p = p + n
        v = 0
        got = 0
        while got < n:
            wi, off = divmod(p + got, 64)
            chunk = min(n - got, 64 - off)
            v |= (
                (int(self.w[wi]) >> off) & ((1 << chunk) - 1)
            ) << got
            got += chunk
        return v

    def bit(self) -> int:
        return self.take(1)


def _elias_delta(bs: _BitStream) -> int:
    """sdsl ``coder::elias_delta`` codeword (gamma-coded bit length,
    then the length-1 low bits)."""
    ell = 0
    while bs.bit() == 0:
        ell += 1
        if ell > 64:
            raise GraphError("xg: malformed elias-delta code")
    length = (1 << ell) | bs.take(ell)
    if length == 1:
        return 1
    return (1 << (length - 1)) | bs.take(length - 1)


def _enc_vector(r: _Reader) -> np.ndarray:
    """sdsl ``enc_vector<elias_delta, 128>`` of a non-decreasing
    sequence: m_size, delta bitstream m_z, samples+pointers vector."""
    n = r.u64()
    zbits = r.u64()
    zw = r.u8()
    if zw != 1:
        raise GraphError(f"xg: enc_vector stream width {zw} != 1")
    nw = (zbits + 63) // 64
    zwords = np.frombuffer(r.raw(8 * nw), dtype="<u8")
    svp = _iv0(r)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    n_samples = (n + 127) // 128
    if len(svp) < 2 * n_samples:
        raise GraphError("xg: enc_vector sample vector too short")
    out = np.zeros(n, dtype=np.int64)
    bs = _BitStream(zwords, zbits)
    for s in range(n_samples):
        base = int(svp[2 * s])
        ptr = int(svp[2 * s + 1])
        if bs.p != ptr:
            raise GraphError("xg: enc_vector sample pointer mismatch")
        out[s * 128] = base
        run = min(128, n - s * 128)
        acc = base
        for j in range(1, run):
            acc += _elias_delta(bs)
            out[s * 128 + j] = acc
    return out


_RRR_SPACE = [comb(63, k).bit_length() if 0 < k < 63 else 0
              for k in range(64)]
_RRR_SPACE_ARR = np.asarray(_RRR_SPACE, dtype=np.int64)
# C(62 - i, k) lookup for the vectorized unranking below; values fit
# int64 (max C(62, 31) ~ 4.5e17)
_COMB62 = np.zeros((63, 64), dtype=np.int64)
for _n in range(63):
    for _k in range(64):
        _COMB62[_n, _k] = comb(_n, _k) if _k <= _n else 0


def _rrr_vector(r: _Reader) -> Tuple[np.ndarray, int]:
    """sdsl ``rrr_vector<63>`` -> (positions of set bits, size).

    Decoding is vectorized across blocks (chromosome-scale paths have
    millions of 63-bit blocks): per-block offset codes are gathered
    with two-word loads at their cumulative bit offsets, then the
    combinatorial-number-system unranking runs as 63 iterations of
    elementwise numpy over ALL blocks at once (~50M blocks/min)."""
    m_size = r.u64()
    bt = _iv0(r)
    bits = r.u64()
    nw = (bits + 63) // 64
    words = np.frombuffer(r.raw(8 * nw), dtype="<u8")
    _iv0(r)  # m_btnrp block pointers (sequential decode needs none)
    _iv0(r)  # m_rank_samples
    nb = len(bt)
    if nb != (m_size + 62) // 63:
        raise GraphError("xg: rrr_vector block count mismatch")
    if nb == 0:
        return np.zeros(0, dtype=np.int64), m_size
    k0 = bt.astype(np.int64)
    space = _RRR_SPACE_ARR[k0]
    off = np.zeros(nb, dtype=np.int64)
    np.cumsum(space[:-1], out=off[1:])
    if nb and int(off[-1] + space[-1]) > bits:
        raise GraphError("xg: rrr_vector offset stream overrun")
    # gather each block's <= 60-bit code: two-word load + funnel shift
    wi = (off >> 6).astype(np.int64)
    sh = (off & 63).astype(np.uint64)
    w = np.concatenate([words, np.zeros(1, dtype="<u8")])
    lo = w[wi] >> sh
    hi = np.where(
        sh == 0, np.uint64(0), w[np.minimum(wi + 1, len(w) - 1)]
        << ((np.uint64(64) - sh) & np.uint64(63))
    )
    mask = np.where(
        space >= 64, ~np.uint64(0),
        (np.uint64(1) << space.astype(np.uint64)) - np.uint64(1),
    )
    code = ((lo | hi) & mask).astype(np.int64)
    # unrank: 63 elementwise iterations over all blocks
    k = k0.copy()
    bitmat = np.zeros((nb, 63), dtype=bool)
    for i in range(63):
        c = _COMB62[62 - i, np.minimum(k, 63)]
        # c == 0 (fewer remaining positions than remaining bits) forces
        # a take, matching comb(n, k) = 0 for k > n in the scalar form;
        # k0 == 63 blocks carry no code and are all-ones
        take = ((k > 0) & (code >= c)) | (k0 == 63)
        bitmat[:, i] = take
        code = np.where(take & (k0 != 63), code - c, code)
        k = np.where(take & (k0 != 63), k - 1, k)
    if np.any(k[k0 != 63] != 0):
        raise GraphError("xg: rrr_vector class/offset mismatch")
    pos = np.flatnonzero(bitmat.reshape(-1)).astype(np.int64)
    if len(pos) and pos[-1] >= m_size:
        raise GraphError("xg: rrr_vector bit beyond size")
    return pos, m_size


# ---------------------------------------------------------------------------
# XG payload
# ---------------------------------------------------------------------------


def _unwrap_vgio(data: bytes) -> bytes:
    """Strip libvgio type-tagged framing (tag ``XG``); accept a bare
    sdsl stream that already starts with the XG magic."""
    if len(data) >= 8 and struct.unpack_from(">I", data, 0)[0] == XG_MAGIC:
        return data
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
            if tag != b"XG":
                raise ValueError
            for _ in range(cnt - 1):
                ln, p = _bytecode(data, p)
                chunks.append(data[p : p + ln])
                p += ln
    except (ValueError, IndexError):
        raise GraphError(
            "not an XG file (neither bare sdsl nor vg type-tagged)"
        )
    return b"".join(chunks)


def _skip_pn_csa(r: _Reader) -> None:
    """Parse-skip the ``csa_wt<wt_huff>`` built over the path-name
    string (wavelet tree, prefix-code tree, SA/ISA samples,
    byte_alphabet).  Content is unused — names come from ``pn_iv``."""
    r.u64()  # wt m_size
    r.u64()  # wt m_sigma
    _, _ = _bv(r)  # wt tree bits
    _skip_rank(r)
    r.skip_select()
    r.skip_select()
    nnodes = r.u64()
    if nnodes > 1 << 20:
        raise GraphError("xg: implausible prefix-code tree size")
    r.p += nnodes * 22  # 22-byte tree nodes (2x u64 + 3x u16)
    r.p += 256 * 2  # char -> leaf table
    r.p += 256 * 8  # char -> path table
    _iv0(r)  # SA samples
    _iv0(r)  # ISA samples
    _skip_fixed_iv(r)  # alphabet char2comp (int_vector<8>)
    _skip_fixed_iv(r)  # alphabet comp2char (int_vector<8>)
    _skip_fixed_iv(r)  # alphabet m_C (int_vector<64>)
    r.p += 2  # alphabet sigma (uint16)


def read_xg(path: str):
    """Parse a ``.xg`` file.

    Returns ``(segments, links, paths)`` in the shapes
    :func:`grafimo_tpu.graph.gfa.tuples_to_sitegraph` consumes:
    segments ``{node_name: seq}``, links ``[(u, '+', v, '+')...]``,
    paths ``{name: [(node_name, '+')...]}``.
    """
    with open(path, "rb") as f:
        payload = _unwrap_vgio(f.read())
    if len(payload) < 60:
        raise GraphError("xg: file too short")
    try:
        return _read_payload(payload)
    except (struct.error, IndexError, ValueError) as exc:
        raise GraphError(f"xg: truncated or corrupt stream ({exc})") \
            from exc


def _read_payload(payload: bytes):
    magic, version = struct.unpack_from(">II", payload, 0)
    if magic != XG_MAGIC:
        raise GraphError(f"xg: bad magic {magic:#x}")
    if not 13 <= version <= 15:
        raise GraphError(f"xg: unsupported XG format version {version}")
    r = _Reader(payload, 8)
    seq_len = r.u64()
    node_count = r.u64()
    edge_count = r.u64()
    path_count = r.u64()
    min_id = r.u64()
    max_id = r.u64()

    id_vec = _iv0(r)  # ids by rank (cross-check only)
    g_iv = _iv0(r)
    g_pos, g_bits = _bv(r)
    _skip_rank(r)
    r.skip_select()
    s_iv = _iv0(r)
    s_pos, s_bits = _bv(r)
    _skip_rank(r)
    r.skip_select()

    if len(g_pos) != node_count:
        raise GraphError("xg: graph record count != node count")
    if g_bits != len(g_iv):
        raise GraphError("xg: graph bit vector / vector size mismatch")
    if len(s_iv) != seq_len:
        raise GraphError("xg: sequence length mismatch")

    # --- decode records: segments + links (vectorized — chromosome-
    # scale graphs have millions of records) ------------------------------
    g = g_iv  # int64 array
    if int(s_iv.max(initial=0)) >= len(_SEQ_CODES):
        raise GraphError("xg: unknown sequence code")
    seq_all = (
        np.frombuffer(_SEQ_CODES.encode(), np.uint8)[s_iv]
        .tobytes().decode()
    )
    # node starts in sequence space: s_bv marks each node start (and,
    # in some builds, an end sentinel)
    sb = s_pos.astype(np.int64)
    if len(sb) == node_count + 1 and sb[-1] == seq_len:
        sb = sb[:-1]
    if len(sb) != node_count:
        raise GraphError("xg: sequence node-start count mismatch")
    sb = np.append(sb, seq_len)

    starts_arr = g_pos.astype(np.int64)
    rec_len = np.diff(np.append(starts_arr, len(g)))
    if np.any(rec_len < 5):
        raise GraphError("xg: truncated graph record")
    nid_arr = g[starts_arr]
    slen = g[starts_arr + 2]
    to_cnt = g[starts_arr + 3]
    from_cnt = g[starts_arr + 4]
    if np.any(rec_len != 5 + to_cnt + from_cnt):
        raise GraphError("xg: graph record size mismatch")
    if np.any((nid_arr < min_id) | (nid_arr > max_id)):
        raise GraphError("xg: node id out of declared range")
    if np.any(np.diff(sb) != slen):
        raise GraphError("xg: node sequence length mismatch")
    # from-edges, flattened over all records
    n_from = int(from_cnt.sum())
    if n_from != edge_count:
        raise GraphError(
            f"xg: decoded {n_from} edges, header says {edge_count}"
        )
    excl = np.zeros(node_count, dtype=np.int64)
    np.cumsum(from_cnt[:-1], out=excl[1:])
    flat = np.arange(n_from, dtype=np.int64) - np.repeat(excl, from_cnt)
    idx = np.repeat(starts_arr + 5 + to_cnt, from_cnt) + flat
    ev = g[idx]
    if np.any(ev & 1):
        raise GraphError(
            "xg: inversion edge (not representable as site alleles)"
        )
    zz = ev >> 1
    delta = np.where(zz % 2 == 0, zz >> 1, -((zz + 1) >> 1))
    other = np.repeat(starts_arr, from_cnt) + delta
    rank_e = np.searchsorted(starts_arr, other)
    if np.any(rank_e >= node_count) or np.any(
        starts_arr[np.minimum(rank_e, node_count - 1)] != other
    ):
        raise GraphError("xg: edge target offset not a record")
    src_ids = np.repeat(nid_arr, from_cnt).tolist()
    dst_ids = nid_arr[rank_e].tolist()
    links: List[Tuple[str, str, str, str]] = [
        (str(a), "+", str(b), "+") for a, b in zip(src_ids, dst_ids)
    ]
    ids = [int(x) for x in nid_arr]
    segments: Dict[str, str] = {
        str(ids[i]): seq_all[sb[i] : sb[i + 1]]
        for i in range(node_count)
    }
    if len(id_vec) == node_count and not np.array_equal(
        np.asarray(id_vec), nid_arr
    ):
        # id vector disagrees with per-record ids: sorted-rank invariant
        # broken somewhere
        raise GraphError("xg: id vector / record id mismatch")

    # --- path names ------------------------------------------------------
    pn_iv = _iv0(r)
    names_str = "".join(chr(int(c)) for c in pn_iv)
    _skip_pn_csa(r)
    pn_pos, pn_bits = _bv(r)
    _skip_rank(r)
    r.skip_select()
    _iv0(r)  # pi_iv (path ids; empty on all observed files)
    path_count2 = r.u64()
    if path_count2 != path_count:
        raise GraphError("xg: path counts disagree (structure drift)")
    if pn_bits != len(pn_iv) or len(pn_pos) != path_count:
        raise GraphError("xg: path name index mismatch")
    name_bounds = [int(x) for x in pn_pos] + [len(names_str)]
    names = []
    for i in range(path_count):
        raw = names_str[name_bounds[i] : name_bounds[i + 1]]
        names.append(raw.lstrip("#").rstrip("$"))

    # --- XGPaths ---------------------------------------------------------
    node_len = np.diff(sb)
    g_pos_arr = starts_arr
    paths: Dict[str, List[Tuple[str, str]]] = {}
    for pi in range(path_count):
        min_handle = r.u64()
        handles = _enc_vector(r) + min_handle
        offsets, off_size = _rrr_vector(r)
        r.u8()  # trailing XGPath flag byte (is_circular slot)
        if np.any(handles & 1):
            raise GraphError("xg: reverse-oriented path step")
        g_off = handles >> 1
        ranks = np.searchsorted(g_pos_arr, g_off)
        if np.any(ranks >= node_count) or np.any(
            g_pos_arr[ranks] != g_off
        ):
            raise GraphError("xg: path handle is not a record offset")
        # invariants: offsets = prefix sums of step lengths
        step_lens = node_len[ranks]
        if off_size != int(step_lens.sum()):
            raise GraphError("xg: path length / offsets size mismatch")
        expect = np.zeros(len(ranks), dtype=np.int64)
        np.cumsum(step_lens[:-1], out=expect[1:])
        if len(offsets) != len(ranks) or np.any(offsets != expect):
            raise GraphError("xg: path offsets / handles mismatch")
        paths[names[pi]] = [(str(ids[int(k)]), "+") for k in ranks]

    return segments, links, paths


def xg_to_sitegraph(
    path: str,
    chrom: Optional[str] = None,
    gbwt: Optional[str] = None,
    strict: bool = False,
) -> SiteGraph:
    """Import a ``.xg`` succinct index as a :class:`SiteGraph`.

    Same flattening core and degradation policy as the ``.gfa``/``.vg``
    importers; haplotypes come from the ``.gbwt`` sidecar when given
    (XG carries only reference paths — vg drops _alt paths at
    indexing, reference ``constructVG.py:394-396``)."""
    segments, links, paths = read_xg(path)
    return tuples_to_sitegraph(
        path, segments, links, paths, [],
        chrom=chrom, gbwt=gbwt, strict=strict,
    )
