"""Native ``.vg`` (vg protobuf Graph stream) import/export.

The reference never parses ``.vg`` itself — it shells out to the vg
binary for every graph operation (``vg construct``/``vg view``/
``vg find``, reference ``constructVG.py:137-293``,
``extract_regions.py:180``).  This module removes that dependency for
the protobuf artifact: a user holding ``vg construct`` output (plus the
usual ``.gbwt`` sidecar for haplotypes) runs findmotif directly, no vg
binary required.  (``.xg`` — vg's succinct sdsl index — remains a
documented one-time ``vg view -g`` conversion, see
``workflows._xg_conversion_error``.)

Format, recovered empirically from vg-built fixtures (and matching the
public vg.proto / libvgio stream framing):

* outer container: BGZF — concatenated gzip members, each carrying a
  ``BC`` extra subfield with the compressed block size (htslib
  convention).  ``gzip.decompress`` handles member concatenation, so
  reading needs no BGZF-specific code; *writing* emits real BGZF blocks
  (+ the 28-byte EOF marker) so vg/htslib can read our exports.
* stream framing: repeated groups of ``varint count`` then ``count``
  length-prefixed items, the first item being the type tag (``"VG"``),
  the rest serialized ``Graph`` messages.
* ``Graph`` wire schema: field 1 = Node{1: sequence, 3: id},
  field 2 = Edge{1: from, 2: to, 3: from_start, 4: to_end},
  field 3 = Path{1: name, 2: Mapping{1: Position{1: node_id,
  4: is_reverse}, 5: rank}}.

Import reduces the protobuf to the same (segments, links, paths, walks)
tuples the GFA parser produces and reuses the snarl-flattening core
(:func:`grafimo_tpu.graph.gfa.tuples_to_sitegraph`), so both vg
artifact flavors behave identically downstream.
"""

import gzip
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from grafimo_tpu_torch.errors import GraphError
from grafimo_tpu_torch.graph.gfa import tuples_to_sitegraph
from grafimo_tpu_torch.graph.sitegraph import SiteGraph

# ---------------------------------------------------------------------------
# protobuf wire primitives (decode)


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    x = 0
    s = 0
    while True:
        b = buf[i]
        i += 1
        x |= (b & 0x7F) << s
        if not b & 0x80:
            return x, i
        s += 7
        if s > 70:
            raise GraphError("malformed varint in .vg stream")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) for one message.  Length-
    delimited values come back as bytes; varints as ints; fixed32/64 as
    raw bytes (unused by the vg schema but tolerated)."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fn, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
            yield fn, wt, v
        elif wt == 2:
            ln, i = _varint(buf, i)
            yield fn, wt, buf[i : i + ln]
            i += ln
        elif wt == 5:
            yield fn, wt, buf[i : i + 4]
            i += 4
        elif wt == 1:
            yield fn, wt, buf[i : i + 8]
            i += 8
        else:
            raise GraphError(f"unsupported protobuf wire type {wt} in .vg")


def read_vg_graph_chunks(path: str) -> List[bytes]:
    """Decompress a ``.vg`` file and return its serialized ``Graph``
    message chunks (type tag ``VG``)."""
    with open(path, "rb") as handle:
        blob = handle.read()
    if blob[:2] == b"\x1f\x8b":
        try:
            raw = gzip.decompress(blob)
        except OSError as e:
            raise GraphError(f"{path}: corrupt BGZF container: {e}")
    else:
        raw = blob  # uncompressed stream (vg view -Vv output)
    chunks: List[bytes] = []
    i = 0
    n = len(raw)
    while i < n:
        count, i = _varint(raw, i)
        if count == 0:
            continue
        tag_len, i = _varint(raw, i)
        tag = raw[i : i + tag_len]
        i += tag_len
        if tag != b"VG":
            raise GraphError(
                f"{path}: stream tagged {tag!r}, not a vg Graph stream "
                f"(is this a .xg/.gbwt? see the conversion hint in the "
                f"findmotif error for those)"
            )
        for _ in range(count - 1):
            ln, i = _varint(raw, i)
            chunks.append(raw[i : i + ln])
            i += ln
    return chunks


# ---------------------------------------------------------------------------
# Graph message -> GFA-equivalent tuples


def parse_vg(path: str):
    """Parse a ``.vg`` protobuf stream into the exact tuple shapes of
    :func:`grafimo_tpu.graph.gfa.parse_gfa`: ``(segments, links, paths,
    walks)`` with node ids stringified.  ``walks`` is always empty —
    vg keeps haplotypes in the ``.gbwt`` sidecar, which the caller
    passes through to the flattening core."""
    segments: Dict[str, str] = {}
    links: List[Tuple[str, str, str, str]] = []
    # path name -> list of (rank, node, orient); ranks order mappings
    # across chunk boundaries (paths are split over Graph messages)
    ranked: Dict[str, List[Tuple[int, str, str]]] = {}
    for chunk in read_vg_graph_chunks(path):
        for fn, _wt, v in _fields(chunk):
            if fn == 1:  # Node
                seq = b""
                nid = 0
                for f2, _w2, v2 in _fields(v):
                    if f2 == 1:
                        seq = v2
                    elif f2 == 3:
                        nid = v2
                segments[str(nid)] = seq.decode("ascii").upper()
            elif fn == 2:  # Edge
                frm = to = 0
                from_start = to_end = False
                for f2, _w2, v2 in _fields(v):
                    if f2 == 1:
                        frm = v2
                    elif f2 == 2:
                        to = v2
                    elif f2 == 3:
                        from_start = bool(v2)
                    elif f2 == 4:
                        to_end = bool(v2)
                links.append(
                    (
                        str(frm),
                        "-" if from_start else "+",
                        str(to),
                        "-" if to_end else "+",
                    )
                )
            elif fn == 3:  # Path
                name = ""
                steps: List[Tuple[int, str, str]] = []
                for f2, _w2, v2 in _fields(v):
                    if f2 == 1:
                        name = v2.decode("utf-8")
                    elif f2 == 2:  # Mapping
                        node = 0
                        rev = False
                        rank = 0
                        for f3, _w3, v3 in _fields(v2):
                            if f3 == 1:  # Position
                                for f4, _w4, v4 in _fields(v3):
                                    if f4 == 1:
                                        node = v4
                                    elif f4 == 4:
                                        rev = bool(v4)
                            elif f3 == 5:
                                rank = v3
                        steps.append((rank, str(node), "-" if rev else "+"))
                ranked.setdefault(name, []).extend(steps)
    paths: Dict[str, List[Tuple[str, str]]] = {}
    for name, steps in ranked.items():
        if any(r for r, _n, _o in steps):
            steps = sorted(steps, key=lambda t: t[0])
        paths[name] = [(n, o) for _r, n, o in steps]
    return segments, links, paths, []


def vg_to_sitegraph(
    path: str,
    chrom: Optional[str] = None,
    gbwt: Optional[str] = None,
    strict: bool = False,
) -> SiteGraph:
    """Import a ``.vg`` protobuf graph as a :class:`SiteGraph`.

    Identical semantics to :func:`~grafimo_tpu.graph.gfa.
    gfa_to_sitegraph` (same flattening core, same per-site degradation
    policy); haplotypes come from the ``.gbwt`` sidecar when given —
    protobuf Paths carry only the reference backbone(s)."""
    segments, links, paths, walks = parse_vg(path)
    return tuples_to_sitegraph(
        path, segments, links, paths, walks,
        chrom=chrom, gbwt=gbwt, strict=strict,
    )


# ---------------------------------------------------------------------------
# export: SiteGraph -> .vg (BGZF-framed protobuf), vg/htslib-readable


def _enc_varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_field(fn: int, wt: int, payload) -> bytes:
    key = _enc_varint((fn << 3) | wt)
    if wt == 0:
        return key + _enc_varint(payload)
    return key + _enc_varint(len(payload)) + payload


def _enc_node(nid: int, seq: str) -> bytes:
    return _enc_field(
        1, 2, _enc_field(1, 2, seq.encode()) + _enc_field(3, 0, nid)
    )


def _enc_edge(u: int, v: int) -> bytes:
    return _enc_field(2, 2, _enc_field(1, 0, u) + _enc_field(2, 0, v))


def _enc_path(name: str, nodes: List[int]) -> bytes:
    body = _enc_field(1, 2, name.encode())
    for rank, nid in enumerate(nodes, 1):
        pos = _enc_field(1, 0, nid)
        mapping = _enc_field(1, 2, pos) + _enc_field(5, 0, rank)
        body += _enc_field(2, 2, mapping)
    return _enc_field(3, 2, body)


_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _bgzf_block(data: bytes, level: int = 6) -> bytes:
    """One BGZF block: gzip member with the htslib ``BC`` (BSIZE) extra
    subfield so vg/htslib's virtual-offset reader accepts it."""
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    deflated = comp.compress(data) + comp.flush()
    bsize = 12 + 6 + len(deflated) + 8  # header+xtra+payload+crc/isize
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<H", 6)
        + b"BC"
        + struct.pack("<HH", 2, bsize - 1)
    )
    return (
        header
        + deflated
        + struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)
    )


def _bgzf_write(path: str, payload: bytes) -> None:
    with open(path, "wb") as out:
        for i in range(0, len(payload), 60000):
            out.write(_bgzf_block(payload[i : i + 60000]))
        out.write(_BGZF_EOF)


def sitegraph_to_vg(graph: SiteGraph, path: str) -> None:
    """Export as a vg-readable ``.vg`` protobuf stream: every node/edge
    of the site graph plus one reference Path.  Haplotypes do NOT ride
    along (vg keeps them in ``.gbwt``); use the GFA 1.1 W-line export
    for a self-contained haplotype round trip."""
    # Same element-walk edge/path derivation as sitegraph_to_gfa, built
    # on integer ids (protobuf wants int64 node ids, GFA wants strings).
    nodes: List[Tuple[int, str]] = [
        (nid, graph.node_seqs[nid])
        for nid in range(1, graph.n_nodes + 1)
        if graph.node_seqs[nid]
    ]
    links: List[Tuple[int, int]] = []
    prev_tails: List[int] = []
    ref_path: List[int] = []
    for kind, idx in graph.elements:
        if kind == "seg":
            links.extend((t, idx) for t in prev_tails)
            prev_tails = [idx]
            ref_path.append(idx)
        else:
            site = graph.sites[idx]
            heads, tails = [], []
            passthrough = False
            for a_idx, allele in enumerate(site.alleles):
                nid = site.allele_nodes[a_idx]
                if allele == "" or nid == 0:
                    passthrough = True
                    continue
                heads.append(nid)
                tails.append(nid)
                if a_idx == 0:
                    ref_path.append(nid)
            links.extend((t, h) for t in prev_tails for h in heads)
            if passthrough:
                tails = tails + prev_tails
            prev_tails = tails

    msgs: List[bytes] = []
    CHUNK = 1000
    for i in range(0, len(nodes), CHUNK):
        msgs.append(
            b"".join(_enc_node(nid, s) for nid, s in nodes[i : i + CHUNK])
        )
    uniq = sorted(set(links))
    for i in range(0, len(uniq), CHUNK):
        msgs.append(b"".join(_enc_edge(u, v) for u, v in uniq[i : i + CHUNK]))
    msgs.append(_enc_path(graph.chrom, ref_path))

    payload = bytearray()
    for m in msgs:
        payload += _enc_varint(2)  # group of 2 items: tag + message
        payload += _enc_varint(2) + b"VG"
        payload += _enc_varint(len(m)) + m
    _bgzf_write(path, bytes(payload))
