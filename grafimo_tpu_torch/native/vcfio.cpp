// vcfio.cpp — threaded VCF body parser for grafimo_tpu.
//
// Replaces the python per-line GT parse for `buildvg` (io/vcf.py is the
// semantic reference; the reference pipeline shells out to tabix + vg,
// constructVG.py:213-236).  Design:
//
//   * the file is mmap'd; three source modes are auto-detected:
//       - BGZF (bgzip, the 1KGP/htslib container): the member headers are
//         scanned serially (14 bytes per 64KB block), then blocks are
//         RAW-inflated IN PARALLEL into large contiguous batches;
//       - plain gzip: serial streaming inflate into batches;
//       - plain text: zero-copy batches over the mapping.
//   * each decompressed batch is split at newlines into per-thread shards
//     and parsed in parallel; a partial trailing line is carried into the
//     next batch, so memory stays bounded (~batch size) regardless of the
//     decompressed VCF size.
//   * genotypes are emitted directly as per-(record, alt-allele) haplotype
//     bitsets — exactly the HaploIndex layout (graph/haplo.py), so graph
//     construction never materialises a per-haplotype int matrix.
//
// Semantics mirror io/vcf.py::iter_vcf_records: records restricted to one
// chromosome; ref/alts uppercased; "." alt dropped (indices NOT reshifted —
// GT allele indices keep their raw column meaning, as in the python reader);
// records whose remaining alts contain symbolic/breakend characters are
// skipped; missing alleles "." count as reference; GT is the prefix of each
// sample field up to ':'; multi-digit allele indices are supported.
//
// Compiled together with graphite.cpp by grafimo_tpu/native/__init__.py
// (g++ -O3 ... -lz) and bound through ctypes.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// Result containers
// ---------------------------------------------------------------------------

struct ShardOut {
  std::vector<int64_t> pos;        // per record
  std::vector<int32_t> n_alt;      // per record (kept alts)
  std::vector<int32_t> row_cnt;    // per record: bitset rows
  std::vector<int64_t> seq_off;    // per allele (ref first), into local blob
  std::vector<int64_t> seq_len;
  std::vector<uint8_t> blob;
  std::vector<int32_t> row_allele; // per row
  std::vector<uint64_t> bits;      // rows * words
  int64_t hap_max = 0;
  int32_t status = 0;              // 0 ok; 2 haplotype capacity exceeded
};

struct VcfResult {
  std::vector<int64_t> pos;
  std::vector<int32_t> n_alt;
  std::vector<int64_t> seq_off;
  std::vector<int64_t> seq_len;
  std::vector<uint8_t> blob;
  std::vector<int64_t> row_off;    // n_records + 1
  std::vector<int32_t> row_allele;
  std::vector<uint64_t> bits;
  int64_t n_hap = 0;
  int64_t words = 0;
  int32_t status = 0;              // 0 ok; 1 io/format error; 2 hap overflow
};

void merge_shard(VcfResult& r, const ShardOut& s) {
  if (s.status) r.status = s.status;
  const int64_t blob_base = (int64_t)r.blob.size();
  r.pos.insert(r.pos.end(), s.pos.begin(), s.pos.end());
  r.n_alt.insert(r.n_alt.end(), s.n_alt.begin(), s.n_alt.end());
  for (size_t i = 0; i < s.seq_off.size(); ++i)
    r.seq_off.push_back(s.seq_off[i] + blob_base);
  r.seq_len.insert(r.seq_len.end(), s.seq_len.begin(), s.seq_len.end());
  r.blob.insert(r.blob.end(), s.blob.begin(), s.blob.end());
  for (int32_t c : s.row_cnt) r.row_off.push_back(r.row_off.back() + c);
  r.row_allele.insert(r.row_allele.end(), s.row_allele.begin(),
                      s.row_allele.end());
  r.bits.insert(r.bits.end(), s.bits.begin(), s.bits.end());
  r.n_hap = std::max(r.n_hap, s.hap_max);
}

// ---------------------------------------------------------------------------
// Line parser
// ---------------------------------------------------------------------------

struct ParseCfg {
  const char* chrom;
  size_t chrom_len;
  int64_t n_samples;
  int64_t cap_hap;    // 2 * n_samples
  int64_t words;      // bitset words per row
};

inline const char* ftab(const char* p, const char* end) {
  return (const char*)memchr(p, '\t', end - p);
}

// Parse every record line in [p, end) into `out`.
void parse_region(const char* p, const char* end, const ParseCfg& cfg,
                  ShardOut& out) {
  std::vector<uint64_t> scratch;              // rec rows * words, zeroed
  std::vector<int32_t> scratch_allele;        // allele per scratch row
  std::vector<int32_t> allele_row;            // allele -> scratch row (+1)
  std::vector<std::pair<const char*, const char*>> alt_spans;

  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    const char* le = nl ? nl : end;
    const char* q = p;
    p = nl ? nl + 1 : end;
    if (le > q && le[-1] == '\r') --le;
    if (le == q || *q == '#') continue;

    const char* t0 = ftab(q, le);
    if (!t0) continue;
    if ((size_t)(t0 - q) != cfg.chrom_len ||
        memcmp(q, cfg.chrom, cfg.chrom_len) != 0)
      continue;

    const char* f = t0 + 1;                   // POS
    const char* t1 = ftab(f, le);
    if (!t1) continue;
    int64_t pos = 0;
    bool pos_ok = (t1 > f);
    for (const char* d = f; d < t1; ++d) {
      if (*d < '0' || *d > '9') { pos_ok = false; break; }
      pos = pos * 10 + (*d - '0');
    }
    if (!pos_ok) continue;

    const char* t2 = ftab(t1 + 1, le);        // ID
    if (!t2) continue;
    const char* ref_b = t2 + 1;               // REF
    const char* t3 = ftab(ref_b, le);
    if (!t3) continue;
    const char* ref_e = t3;
    const char* alt_b = t3 + 1;               // ALT
    const char* t4 = ftab(alt_b, le);
    const char* alt_e = t4 ? t4 : le;

    // split alts on ',', drop "." (indices keep raw column meaning),
    // skip record if any kept alt is symbolic/breakend
    alt_spans.clear();
    bool symbolic = false;
    for (const char* a = alt_b; a <= alt_e;) {
      const char* c = (const char*)memchr(a, ',', alt_e - a);
      const char* ae = c ? c : alt_e;
      if (!(ae - a == 1 && *a == '.') && ae > a) {
        for (const char* s = a; s < ae; ++s)
          if (*s == '<' || *s == '>' || *s == '[' || *s == ']')
            symbolic = true;
        alt_spans.push_back({a, ae});
      }
      if (!c) break;
      a = c + 1;
    }
    if (alt_spans.empty() || symbolic) continue;

    out.pos.push_back(pos);
    out.n_alt.push_back((int32_t)alt_spans.size());
    auto push_seq = [&](const char* b, const char* e) {
      out.seq_off.push_back((int64_t)out.blob.size());
      out.seq_len.push_back((int64_t)(e - b));
      for (const char* s = b; s < e; ++s)
        out.blob.push_back((uint8_t)((*s >= 'a' && *s <= 'z')
                                         ? *s - ('a' - 'A') : *s));
    };
    push_seq(ref_b, ref_e);
    for (auto& sp : alt_spans) push_seq(sp.first, sp.second);

    // ---- genotypes -> bitsets ------------------------------------------
    int32_t n_rows = 0;
    if (cfg.n_samples > 0 && t4) {
      // skip QUAL FILTER INFO FORMAT
      const char* s = t4 + 1;
      const char* t = s;
      bool have_samples = true;
      for (int i = 0; i < 4; ++i) {
        t = ftab(s, le);
        if (!t) { have_samples = false; break; }
        s = t + 1;
      }
      if (have_samples) {
        scratch.clear();
        scratch_allele.clear();
        int64_t h = 0;
        bool overflow = false;
        auto set_bit = [&](int64_t allele, int64_t hh) {
          if ((int64_t)allele_row.size() <= allele)
            allele_row.resize(allele + 1, 0);
          int32_t row = allele_row[allele];
          if (row == 0) {
            scratch.resize(scratch.size() + cfg.words, 0);
            scratch_allele.push_back((int32_t)allele);
            row = (int32_t)scratch_allele.size();
            allele_row[allele] = row;
          }
          scratch[(int64_t)(row - 1) * cfg.words + (hh >> 6)] |=
              (uint64_t)1 << (hh & 63);
        };
        const char* cell = s;
        while (cell <= le && !overflow) {
          const char* ce = ftab(cell, le);
          if (!ce) ce = le;
          // fast path: the dominant "a|b" single-digit diploid cell
          if (ce - cell >= 3 && (cell[1] == '|' || cell[1] == '/') &&
              (uint8_t)(cell[0] - '0') <= 9 &&
              (uint8_t)(cell[2] - '0') <= 9 &&
              (ce - cell == 3 || cell[3] == ':')) {
            if (h + 2 > cfg.cap_hap) { overflow = true; break; }
            if (cell[0] != '0') set_bit(cell[0] - '0', h);
            if (cell[2] != '0') set_bit(cell[2] - '0', h + 1);
            h += 2;
            if (ce >= le) break;
            cell = ce + 1;
            continue;
          }
          // GT = prefix up to ':'
          const char* ge = (const char*)memchr(cell, ':', ce - cell);
          if (!ge) ge = ce;
          const char* a = cell;
          while (a <= ge) {
            const char* asep = a;
            while (asep < ge && *asep != '|' && *asep != '/') ++asep;
            // token [a, asep)
            int64_t allele = 0;
            bool ok = true;
            if (asep == a || (asep - a == 1 && *a == '.')) {
              allele = 0;  // missing -> reference
            } else {
              for (const char* d = a; d < asep; ++d) {
                if (*d < '0' || *d > '9') { ok = false; break; }
                allele = allele * 10 + (*d - '0');
                if (allele > (1 << 20)) { ok = false; break; }
              }
              if (!ok) allele = 0;  // malformed token -> reference
            }
            if (h >= cfg.cap_hap) { overflow = true; break; }
            if (allele > 0) set_bit(allele, h);
            ++h;
            if (asep >= ge) break;
            a = asep + 1;
          }
          if (ce >= le) break;
          cell = ce + 1;
        }
        if (overflow) { out.status = 2; }
        out.hap_max = std::max(out.hap_max, h);
        // emit rows in ascending allele order (np.unique parity)
        n_rows = (int32_t)scratch_allele.size();
        std::vector<int32_t> order(n_rows);
        for (int32_t i = 0; i < n_rows; ++i) order[i] = i;
        std::sort(order.begin(), order.end(), [&](int32_t x, int32_t y) {
          return scratch_allele[x] < scratch_allele[y];
        });
        for (int32_t i : order) {
          out.row_allele.push_back(scratch_allele[i]);
          const uint64_t* w = scratch.data() + (int64_t)i * cfg.words;
          out.bits.insert(out.bits.end(), w, w + cfg.words);
        }
        for (int32_t a : scratch_allele) allele_row[a] = 0;
      }
    }
    out.row_cnt.push_back(n_rows);
  }
}

// ---------------------------------------------------------------------------
// Batch driver: decompressed text arrives in large chunks; header + line
// carry are handled serially, record bodies are parsed in parallel shards.
// ---------------------------------------------------------------------------

struct BatchParser {
  ParseCfg cfg{};
  VcfResult* res;
  int64_t n_threads;
  std::string carry;          // partial trailing line
  bool header_done = false;
  bool saw_chrom_line = false;

  explicit BatchParser(VcfResult* r, int64_t nt) : res(r), n_threads(nt) {
    res->row_off.push_back(0);
  }

  // Count samples on the #CHROM line.
  void parse_header_line(const char* b, const char* e) {
    if ((size_t)(e - b) >= 6 && memcmp(b, "#CHROM", 6) == 0) {
      int64_t tabs = 0;
      for (const char* s = b; s < e; ++s) tabs += (*s == '\t');
      cfg.n_samples = std::max<int64_t>(0, tabs + 1 - 9);
      cfg.cap_hap = 2 * cfg.n_samples;
      cfg.words = (cfg.cap_hap + 63) / 64;
      saw_chrom_line = true;
    }
  }

  void feed(const char* data, size_t len, bool final) {
    const char* p = data;
    const char* end = data + len;

    // stitch the carried partial line with this batch's first line
    if (!carry.empty()) {
      const char* nl = (const char*)memchr(p, '\n', end - p);
      if (!nl && !final) { carry.append(p, end - p); return; }
      const char* le = nl ? nl + 1 : end;
      carry.append(p, le - p);
      p = le;
      consume_serial(carry.data(), carry.data() + carry.size());
      carry.clear();
    }

    // serial header consumption
    while (!header_done && p < end) {
      if (*p != '#') { header_done = true; break; }
      const char* nl = (const char*)memchr(p, '\n', end - p);
      if (!nl) {
        if (final) { parse_header_line(p, end); p = end; break; }
        carry.assign(p, end - p);
        return;
      }
      parse_header_line(p, nl);
      p = nl + 1;
    }
    if (p >= end) return;

    // body region: [p, last newline]; tail is carried
    const char* last_nl = nullptr;
    for (const char* s = end; s > p; --s)
      if (s[-1] == '\n') { last_nl = s; break; }
    const char* body_end = last_nl ? last_nl : p;
    if (final) body_end = end;
    if (!final) carry.assign(body_end, end - body_end);

    if (body_end <= p) return;
    const int64_t nt = std::max<int64_t>(
        1, std::min<int64_t>(n_threads, (body_end - p) / (1 << 20) + 1));
    std::vector<ShardOut> shards(nt);
    std::vector<const char*> cut(nt + 1);
    cut[0] = p;
    cut[nt] = body_end;
    for (int64_t i = 1; i < nt; ++i) {
      const char* g = p + (body_end - p) * i / nt;
      const char* nl = (const char*)memchr(g, '\n', body_end - g);
      cut[i] = nl ? nl + 1 : body_end;
    }
    for (int64_t i = 1; i < nt; ++i) cut[i] = std::max(cut[i], cut[i - 1]);
    std::vector<std::thread> pool;
    for (int64_t i = 0; i < nt; ++i)
      pool.emplace_back([&, i] {
        parse_region(cut[i], cut[i + 1], cfg, shards[i]);
      });
    for (auto& t : pool) t.join();
    for (auto& s : shards) merge_shard(*res, s);
  }

  // parse a stitched line (or early header lines) serially
  void consume_serial(const char* b, const char* e) {
    const char* p = b;
    while (p < e) {
      const char* nl = (const char*)memchr(p, '\n', e - p);
      const char* le = nl ? nl : e;
      if (le > p && *p == '#') {
        parse_header_line(p, le);
      } else if (le > p && header_done_or_mark()) {
        ShardOut s;
        parse_region(p, le, cfg, s);
        merge_shard(*res, s);
      }
      p = nl ? nl + 1 : e;
    }
  }

  bool header_done_or_mark() {
    header_done = true;
    return true;
  }

  void finish() {
    if (!carry.empty()) {
      consume_serial(carry.data(), carry.data() + carry.size());
      carry.clear();
    }
    res->words = cfg.words;
  }
};

// ---------------------------------------------------------------------------
// Source modes
// ---------------------------------------------------------------------------

struct Mapped {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t len = 0;
  bool ok = false;
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size < 0) { close(m.fd); m.fd = -1; return m; }
  m.len = (size_t)st.st_size;
  if (m.len == 0) { m.ok = true; return m; }
  void* d = mmap(nullptr, m.len, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (d == MAP_FAILED) { close(m.fd); m.fd = -1; return m; }
  m.data = (const uint8_t*)d;
  madvise((void*)m.data, m.len, MADV_SEQUENTIAL);
  m.ok = true;
  return m;
}

void unmap_file(Mapped& m) {
  if (m.data) munmap((void*)m.data, m.len);
  if (m.fd >= 0) close(m.fd);
}

bool is_gzip(const uint8_t* d, size_t len) {
  return len >= 2 && d[0] == 0x1f && d[1] == 0x8b;
}

// Parse a BGZF member header at d (within [d, end)); returns the total
// block length (BSIZE + 1) or 0 when this is not a valid BGZF member.
size_t bgzf_block_len(const uint8_t* d, size_t avail, size_t* hdr_len) {
  if (avail < 18 || d[0] != 0x1f || d[1] != 0x8b || d[2] != 8 ||
      !(d[3] & 4))
    return 0;
  size_t xlen = (size_t)d[10] | ((size_t)d[11] << 8);
  if (12 + xlen > avail) return 0;
  size_t p = 12, e = 12 + xlen;
  while (p + 4 <= e) {
    uint8_t s1 = d[p], s2 = d[p + 1];
    size_t sl = (size_t)d[p + 2] | ((size_t)d[p + 3] << 8);
    if (s1 == 'B' && s2 == 'C' && sl == 2 && p + 6 <= e) {
      size_t bsize = (size_t)d[p + 4] | ((size_t)d[p + 5] << 8);
      *hdr_len = 12 + xlen;
      return bsize + 1;
    }
    p += 4 + sl;
  }
  return 0;
}

struct BgzfBlock {
  size_t coff;   // compressed payload offset in the file
  size_t clen;   // compressed payload length
  size_t dlen;   // decompressed length (ISIZE)
  size_t doff;   // offset into the batch decompression buffer
};

// Decompress one raw-deflate BGZF payload.
bool inflate_raw(const uint8_t* src, size_t slen, uint8_t* dst, size_t dlen) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = (Bytef*)src;
  zs.avail_in = (uInt)slen;
  zs.next_out = dst;
  zs.avail_out = (uInt)dlen;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END && zs.avail_out == 0;
}

int scan_bgzf(const Mapped& m, BatchParser& bp, int64_t n_threads,
              size_t batch_bytes) {
  size_t off = 0;
  std::vector<BgzfBlock> blocks;
  std::vector<uint8_t> buf;
  while (off < m.len) {
    blocks.clear();
    size_t dtotal = 0;
    while (off < m.len && dtotal < batch_bytes) {
      size_t hdr = 0;
      size_t blen = bgzf_block_len(m.data + off, m.len - off, &hdr);
      if (blen == 0 || off + blen > m.len) return 1;
      const uint8_t* tail = m.data + off + blen - 4;
      size_t isize = (size_t)tail[0] | ((size_t)tail[1] << 8) |
                     ((size_t)tail[2] << 16) | ((size_t)tail[3] << 24);
      if (isize > (1u << 20)) return 1;  // BGZF blocks are <= 64KiB
      if (isize > 0)
        blocks.push_back({off + hdr, blen - hdr - 8, isize, dtotal});
      dtotal += isize;
      off += blen;
    }
    if (dtotal == 0) continue;
    buf.resize(dtotal);
    std::atomic<size_t> next{0};
    std::atomic<int> err{0};
    int64_t nt = std::max<int64_t>(1, std::min<int64_t>(n_threads,
                                                        (int64_t)blocks.size()));
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < nt; ++t)
      pool.emplace_back([&] {
        for (;;) {
          size_t i = next.fetch_add(1);
          if (i >= blocks.size()) break;
          const BgzfBlock& b = blocks[i];
          if (!inflate_raw(m.data + b.coff, b.clen, buf.data() + b.doff,
                           b.dlen))
            err.store(1);
        }
      });
    for (auto& t : pool) t.join();
    if (err.load()) return 1;
    bp.feed((const char*)buf.data(), dtotal, off >= m.len);
  }
  return 0;
}

int scan_gzip(const Mapped& m, BatchParser& bp, size_t batch_bytes) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 32) != Z_OK) return 1;
  size_t consumed = 0;
  std::vector<uint8_t> buf(batch_bytes);
  bool done = false;
  // a stream that exhausts its input mid-member is TRUNCATED — that must
  // surface as an error, never as a silent partial read (the python
  // reader raises EOFError; io/vcf.py falls back to it on status != 0)
  bool at_member_end = false;
  while (!done) {
    zs.next_out = buf.data();
    zs.avail_out = (uInt)buf.size();
    while (zs.avail_out > 0 && !done) {
      if (zs.avail_in == 0) {
        if (consumed >= m.len) { done = true; break; }
        zs.next_in = (Bytef*)(m.data + consumed);
        zs.avail_in = (uInt)std::min<size_t>(m.len - consumed, 1u << 30);
        consumed += zs.avail_in;
      }
      int rc = inflate(&zs, Z_NO_FLUSH);
      if (rc == Z_STREAM_END) {
        at_member_end = true;
        // concatenated members (BGZF is one such case): reset + continue
        if (zs.avail_in == 0 && consumed >= m.len) { done = true; break; }
        if (inflateReset(&zs) != Z_OK) { inflateEnd(&zs); return 1; }
      } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
        inflateEnd(&zs);
        return 1;
      } else if (rc == Z_BUF_ERROR && zs.avail_in == 0 &&
                 consumed >= m.len) {
        done = true;
      } else {
        at_member_end = false;
      }
    }
    size_t got = buf.size() - zs.avail_out;
    if (got > 0 || done) bp.feed((const char*)buf.data(), got, done);
  }
  inflateEnd(&zs);
  return at_member_end ? 0 : 1;  // partial results are discarded on error
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* vcfio_scan(const uint8_t* path, int64_t path_len, const uint8_t* chrom,
                 int64_t chrom_len, int64_t n_threads, int32_t* status) {
  std::string spath((const char*)path, (size_t)path_len);
  std::string schrom((const char*)chrom, (size_t)chrom_len);
  if (n_threads <= 0)
    n_threads = (int64_t)std::max(1u, std::thread::hardware_concurrency());
  auto* res = new VcfResult();
  BatchParser bp(res, n_threads);
  bp.cfg.chrom = schrom.c_str();
  bp.cfg.chrom_len = schrom.size();

  Mapped m = map_file(spath.c_str());
  if (!m.ok) {
    res->status = 1;
    *status = 1;
    return res;
  }
  const size_t batch_bytes = 256u << 20;
  int rc = 0;
  if (m.len == 0) {
    // empty file: nothing to parse
  } else if (is_gzip(m.data, m.len)) {
    size_t hdr = 0;
    if (bgzf_block_len(m.data, m.len, &hdr) > 0)
      rc = scan_bgzf(m, bp, n_threads, batch_bytes);
    else
      rc = scan_gzip(m, bp, batch_bytes);
  } else {
    bp.feed((const char*)m.data, m.len, true);
  }
  unmap_file(m);
  bp.finish();
  if (rc) res->status = 1;
  *status = res->status;
  return res;
}

int64_t vcfio_n_records(void* h) { return (int64_t)((VcfResult*)h)->pos.size(); }
int64_t vcfio_n_hap(void* h) { return ((VcfResult*)h)->n_hap; }
int64_t vcfio_words(void* h) { return ((VcfResult*)h)->words; }
int64_t vcfio_n_alleles(void* h) {
  return (int64_t)((VcfResult*)h)->seq_off.size();
}
int64_t vcfio_blob_len(void* h) { return (int64_t)((VcfResult*)h)->blob.size(); }
int64_t vcfio_n_rows(void* h) {
  return (int64_t)((VcfResult*)h)->row_allele.size();
}

void vcfio_export(void* h, int64_t* pos, int32_t* n_alt, int64_t* seq_off,
                  int64_t* seq_len, uint8_t* blob, int64_t* row_off,
                  int32_t* row_allele, uint64_t* bits) {
  const VcfResult* r = (const VcfResult*)h;
  memcpy(pos, r->pos.data(), r->pos.size() * sizeof(int64_t));
  memcpy(n_alt, r->n_alt.data(), r->n_alt.size() * sizeof(int32_t));
  memcpy(seq_off, r->seq_off.data(), r->seq_off.size() * sizeof(int64_t));
  memcpy(seq_len, r->seq_len.data(), r->seq_len.size() * sizeof(int64_t));
  if (!r->blob.empty()) memcpy(blob, r->blob.data(), r->blob.size());
  memcpy(row_off, r->row_off.data(), r->row_off.size() * sizeof(int64_t));
  if (!r->row_allele.empty())
    memcpy(row_allele, r->row_allele.data(),
           r->row_allele.size() * sizeof(int32_t));
  if (!r->bits.empty())
    memcpy(bits, r->bits.data(), r->bits.size() * sizeof(uint64_t));
}

void vcfio_free(void* h) { delete (VcfResult*)h; }

}  // extern "C"
