// Native event-log storage engine — append-only binary log + filtered scan.
//
// The port's copy of the reference's event_log.cpp: the same C ABI and the
// same on-disk format, so a log written by either package is read by the
// other. One append-only record log per (app, channel) with the
// filter/sort/tombstone logic in C++, so the training read
// (PEvents.find_frame feeding the templates' data sources) never loops over
// records in Python. Exposed through a C ABI consumed with ctypes
// (pio_tpu_torch/native/__init__.py builds this file with g++ on first use).
//
// Record layout (little-endian), file = 8-byte magic "PEL2\0\0\0\0" then
// records:
//   u32  payload_len                  (bytes after this field, before crc)
//   u8   flags                        (bit0 = tombstone: event_id names the
//                                      record to delete)
//   i64  event_time_us
//   i64  creation_time_us
//   u16  len[8]: event_id, event, entity_type, entity_id,
//                target_entity_type, target_entity_id, pr_id, tags_json
//   u32  len_props_json
//   bytes: the 9 strings concatenated (utf-8)
//   u32  crc32 of the payload (zlib polynomial; v2 only)
//
// v1 files ("PEL1" magic, no per-record crc) remain readable; pel_repair
// upgrades them in place (atomic rewrite) before any v2-framed append.
// The crc turns "plausible-length garbage at the tail" — a torn write the
// length check alone can't see — into a detected torn tail, and garbage
// anywhere else into detected corruption instead of silently-wrong scans.

#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr char kMagicV1[8] = {'P', 'E', 'L', '1', 0, 0, 0, 0};
constexpr char kMagicV2[8] = {'P', 'E', 'L', '2', 0, 0, 0, 0};
constexpr int kNumStr = 9;  // 8 u16-length strings + props (u32 length)
constexpr size_t kHeaderFixed = 1 + 8 + 8 + 8 * 2 + 4;

// zlib-compatible CRC-32 (poly 0xEDB88320), so Python's zlib.crc32 frames
// records the scanner verifies without linking -lz into the .so.
struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};

uint32_t crc32_feed(uint32_t crc, const char* data, size_t len) {
  static const Crc32Table tbl;
  for (size_t i = 0; i < len; ++i)
    crc = tbl.t[(crc ^ static_cast<uint8_t>(data[i])) & 0xFFu] ^ (crc >> 8);
  return crc;
}

uint32_t crc32_of(const char* data, size_t len) {
  return crc32_feed(0xFFFFFFFFu, data, len) ^ 0xFFFFFFFFu;
}

struct Rec {
  uint8_t flags;
  int64_t time_us;
  int64_t ctime_us;
  const char* str[kNumStr];
  uint32_t len[kNumStr];
  int64_t seq;  // file order, for a stable sort
};

template <typename T>
T read_le(const char* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

// Last-write-wins filter shared by scan/count/compact: the newest record
// per event id (by file order) is authoritative; a tombstone as winner
// kills the id. Appends the surviving records to *live in file order.
void collect_live(const std::vector<Rec>& recs,
                  std::vector<const Rec*>* live) {
  std::unordered_map<std::string, int64_t> last;
  for (const Rec& r : recs) last[std::string(r.str[0], r.len[0])] = r.seq;
  for (const Rec& r : recs) {
    if (r.flags & 1) continue;
    if (last[std::string(r.str[0], r.len[0])] != r.seq) continue;
    live->push_back(&r);
  }
}

// Parses whole records. A *torn tail* — a trailing partial record left by a
// crash mid-append (the bytes are a prefix of one framed record) — is NOT
// corruption: parsing stops there and *valid_end marks the end of the last
// whole record, so committed data stays readable. A v2 record whose crc
// mismatches is a torn tail IF it is the final record (in-place garbage
// from a failed write), and corruption otherwise. Only mid-record
// inconsistencies (bad magic, lengths that disagree within fully-present
// bytes, a mid-file crc mismatch) return false.
// out may be null (framing/validation walk only — no Rec materialization;
// pel_repair uses this to find valid_end without O(records) memory).
// version_out (may be null) reports the file format: 1, or 2 (also for
// empty/absent files, which pel_append will create as v2).
bool parse_records(const std::vector<char>& buf, std::vector<Rec>* out,
                   size_t* valid_end, int* version_out = nullptr) {
  *valid_end = 0;
  int version = 2;
  if (buf.size() >= 8) {
    if (std::memcmp(buf.data(), kMagicV2, 8) == 0)
      version = 2;
    else if (std::memcmp(buf.data(), kMagicV1, 8) == 0)
      version = 1;
    else
      return false;
  }
  if (version_out) *version_out = version;
  if (buf.size() < 8) return true;  // empty or torn magic
  const size_t trailer = version == 2 ? 4 : 0;  // per-record crc32
  size_t pos = 8;
  *valid_end = pos;
  int64_t seq = 0;
  while (pos + 4 <= buf.size()) {
    uint32_t plen = read_le<uint32_t>(buf.data() + pos);
    if (plen < kHeaderFixed) return false;
    if (pos + 4 + plen + trailer > buf.size()) return true;  // torn tail
    const char* p = buf.data() + pos + 4;
    if (version == 2) {
      uint32_t want = read_le<uint32_t>(p + plen);
      if (crc32_of(p, plen) != want)
        // garbled final record = torn tail (truncate); earlier = corrupt
        return pos + 4 + plen + trailer == buf.size();
    }
    Rec r;
    r.flags = static_cast<uint8_t>(*p);
    r.time_us = read_le<int64_t>(p + 1);
    r.ctime_us = read_le<int64_t>(p + 9);
    size_t off = 17;
    uint64_t total = 0;
    for (int i = 0; i < kNumStr - 1; ++i) {
      r.len[i] = read_le<uint16_t>(p + off);
      off += 2;
      total += r.len[i];
    }
    r.len[kNumStr - 1] = read_le<uint32_t>(p + off);
    off += 4;
    total += r.len[kNumStr - 1];
    if (off + total != plen) return false;
    const char* s = p + off;
    for (int i = 0; i < kNumStr; ++i) {
      r.str[i] = s;
      s += r.len[i];
    }
    r.seq = seq++;
    if (out) out->push_back(r);
    pos += 4 + plen + trailer;
    *valid_end = pos;
  }
  return true;
}

// Writes magic + the given records re-framed as v2 (crc per record).
// Shared by pel_compact and pel_repair's v1 → v2 upgrade.
bool write_records_v2(FILE* f, const std::vector<const Rec*>& recs) {
  bool ok = std::fwrite(kMagicV2, 1, 8, f) == 8;
  for (const Rec* r : recs) {
    if (!ok) break;
    uint64_t payload = kHeaderFixed;
    for (int c = 0; c < kNumStr; ++c) payload += r->len[c];
    uint32_t plen = static_cast<uint32_t>(payload);
    char head[4 + kHeaderFixed];
    std::memcpy(head, &plen, 4);
    char* p = head + 4;
    p[0] = static_cast<char>(r->flags);
    std::memcpy(p + 1, &r->time_us, 8);
    std::memcpy(p + 9, &r->ctime_us, 8);
    size_t off = 17;
    for (int c = 0; c < kNumStr - 1; ++c) {
      uint16_t l16 = static_cast<uint16_t>(r->len[c]);
      std::memcpy(p + off, &l16, 2);
      off += 2;
    }
    std::memcpy(p + off, &r->len[kNumStr - 1], 4);
    uint32_t crc = crc32_feed(0xFFFFFFFFu, head + 4, kHeaderFixed);
    ok = std::fwrite(head, 1, sizeof(head), f) == sizeof(head);
    for (int c = 0; ok && c < kNumStr; ++c)
      if (r->len[c]) {
        ok = std::fwrite(r->str[c], 1, r->len[c], f) == r->len[c];
        crc = crc32_feed(crc, r->str[c], r->len[c]);
      }
    crc ^= 0xFFFFFFFFu;
    ok = ok && std::fwrite(&crc, 1, 4, f) == 4;
  }
  return ok;
}

bool read_file(const char* path, std::vector<char>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return errno == ENOENT;  // only an absent file is an empty log
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(buf->data(), 1, buf->size(), f) : 0;
  std::fclose(f);
  return got == buf->size();
}

bool str_eq(const char* a, uint32_t alen, const char* b) {
  return std::strlen(b) == alen && std::memcmp(a, b, alen) == 0;
}

// filter string sets arrive as "name1\0name2\0" (count separately)
bool in_set(const char* s, uint32_t slen, const char* set, int count) {
  const char* p = set;
  for (int i = 0; i < count; ++i) {
    size_t l = std::strlen(p);
    if (l == slen && std::memcmp(p, s, l) == 0) return true;
    p += l + 1;
  }
  return false;
}

}  // namespace

extern "C" {

// Columnar scan result. String column i: chars arena[off[i][k]..off[i][k+1])
// for row k; off arrays have n+1 entries. Free with pel_free_result.
typedef struct {
  int64_t n;
  int64_t* time_us;
  int64_t* ctime_us;
  char* arena[kNumStr];
  uint32_t* off[kNumStr];
} PelResult;

void pel_free_result(PelResult* r);

// Appends pre-encoded record bytes (Python frames them, v2 with crc);
// creates the file with magic if needed. do_sync != 0 → fsync before
// close (the durability knob: "commit" always, "batch" on its interval).
// Returns 0 on success.
int pel_append(const char* path, const uint8_t* data, int64_t len,
               int do_sync) {
  FILE* f = std::fopen(path, "ab");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  if (std::ftell(f) == 0) {
    if (std::fwrite(kMagicV2, 1, sizeof(kMagicV2), f) !=
        sizeof(kMagicV2)) {
      std::fclose(f);
      return -1;
    }
  }
  size_t wrote = std::fwrite(data, 1, static_cast<size_t>(len), f);
  // fflush+fclose must BOTH succeed: stdio buffering means fwrite can
  // report full length while the actual write (ENOSPC, EIO) fails at
  // flush — returning 0 then would claim persistence that never happened
  bool flushed = std::fflush(f) == 0;
  bool synced = !do_sync || (flushed && fsync(fileno(f)) == 0);
  bool closed = std::fclose(f) == 0;
  return (wrote == static_cast<size_t>(len) && flushed && synced && closed)
             ? 0
             : -1;
}

// Filtered scan. Empty-string filters mean "any"; event_names is a packed
// set ("a\0b\0", event_name_count entries, 0 = any). start/until in
// microseconds (INT64_MIN/MAX = unbounded; until is exclusive).
// reversed != 0 → newest first. limit < 0 → no limit.
// event_id filter ("" = any) serves LEvents.get. (The Python wrapper maps
// explicit empty-string filters to "match nothing" before the ABI.)
// Returns 0 ok, -1 io error, -2 corrupt file, -3 result too large
// (a string column would overflow the u32 offset arrays), -4 out of
// memory. Never throws across the C ABI.
static int pel_scan_impl(const char* path, const char* event_names,
                         int event_name_count, const char* entity_type,
                         const char* entity_id,
                         const char* target_entity_type,
                         const char* target_entity_id, const char* event_id,
                         int64_t start_us, int64_t until_us, int reversed,
                         int64_t limit, PelResult* out) {
  std::vector<char> buf;
  if (!read_file(path, &buf)) return -1;
  std::vector<Rec> recs;
  size_t valid_end;
  if (!parse_records(buf, &recs, &valid_end)) return -2;

  // last-write-wins per event_id (collect_live): re-insert after delete
  // resurrects the id, inserting an existing id replaces it — matching
  // the upsert/delete semantics of the SQLite and memory backends.
  std::vector<const Rec*> live;
  collect_live(recs, &live);

  std::vector<const Rec*> hits;
  for (const Rec* rp : live) {
    const Rec& r = *rp;
    if (r.time_us < start_us || r.time_us >= until_us) continue;
    if (event_name_count > 0 &&
        !in_set(r.str[1], r.len[1], event_names, event_name_count))
      continue;
    if (entity_type[0] && !str_eq(r.str[2], r.len[2], entity_type)) continue;
    if (entity_id[0] && !str_eq(r.str[3], r.len[3], entity_id)) continue;
    if (target_entity_type[0] &&
        !str_eq(r.str[4], r.len[4], target_entity_type))
      continue;
    if (target_entity_id[0] &&
        !str_eq(r.str[5], r.len[5], target_entity_id))
      continue;
    if (event_id[0] && !str_eq(r.str[0], r.len[0], event_id)) continue;
    hits.push_back(&r);
  }

  std::sort(hits.begin(), hits.end(), [&](const Rec* a, const Rec* b) {
    if (a->time_us != b->time_us)
      return reversed ? a->time_us > b->time_us : a->time_us < b->time_us;
    return reversed ? a->seq > b->seq : a->seq < b->seq;
  });
  if (limit >= 0 && static_cast<int64_t>(hits.size()) > limit)
    hits.resize(static_cast<size_t>(limit));

  const int64_t n = static_cast<int64_t>(hits.size());
  out->n = n;
  out->time_us =
      static_cast<int64_t*>(std::malloc(sizeof(int64_t) * (n ? n : 1)));
  out->ctime_us =
      static_cast<int64_t*>(std::malloc(sizeof(int64_t) * (n ? n : 1)));
  if (!out->time_us || !out->ctime_us) {
    pel_free_result(out);
    return -4;
  }
  for (int c = 0; c < kNumStr; ++c) {
    uint64_t total = 0;
    for (const Rec* r : hits) total += r->len[c];
    if (total > UINT32_MAX) {
      pel_free_result(out);
      return -3;
    }
    out->arena[c] = static_cast<char*>(std::malloc(total ? total : 1));
    out->off[c] =
        static_cast<uint32_t*>(std::malloc(sizeof(uint32_t) * (n + 1)));
    if (!out->arena[c] || !out->off[c]) {
      pel_free_result(out);
      return -4;
    }
    uint32_t pos = 0;
    for (int64_t k = 0; k < n; ++k) {
      out->off[c][k] = pos;
      std::memcpy(out->arena[c] + pos, hits[k]->str[c], hits[k]->len[c]);
      pos += hits[k]->len[c];
    }
    out->off[c][n] = pos;
  }
  for (int64_t k = 0; k < n; ++k) {
    out->time_us[k] = hits[k]->time_us;
    out->ctime_us[k] = hits[k]->ctime_us;
  }
  return 0;
}

int pel_scan(const char* path, const char* event_names,
             int event_name_count, const char* entity_type,
             const char* entity_id, const char* target_entity_type,
             const char* target_entity_id, const char* event_id,
             int64_t start_us, int64_t until_us, int reversed,
             int64_t limit, PelResult* out) {
  std::memset(out, 0, sizeof(*out));
  try {
    return pel_scan_impl(path, event_names, event_name_count, entity_type,
                         entity_id, target_entity_type, target_entity_id,
                         event_id, start_us, until_us, reversed, limit,
                         out);
  } catch (...) {  // bad_alloc from vector/string growth, most likely
    pel_free_result(out);
    return -4;
  }
}

void pel_free_result(PelResult* r) {
  std::free(r->time_us);
  std::free(r->ctime_us);
  for (int c = 0; c < kNumStr; ++c) {
    std::free(r->arena[c]);
    std::free(r->off[c]);
  }
  std::memset(r, 0, sizeof(*r));
}

// Count live (non-tombstoned) records; -1 io error, -2 corrupt, -4 oom.
int64_t pel_count(const char* path) {
  try {
    std::vector<char> buf;
    if (!read_file(path, &buf)) return -1;
    std::vector<Rec> recs;
    size_t valid_end;
    if (!parse_records(buf, &recs, &valid_end)) return -2;
    std::vector<const Rec*> live;
    collect_live(recs, &live);
    return static_cast<int64_t>(live.size());
  } catch (...) {
    return -4;
  }
}

// Truncates a torn tail (partial record left by a crash mid-append) so
// later appends don't land after unreachable bytes, and upgrades v1 files
// to v2 (atomic rewrite adding per-record crcs) — appends are always
// v2-framed, so a v1 file must be converted before its first append.
// Called by the Python wrapper once per file before its first append in a
// process. Returns the number of torn-tail bytes dropped (0 = clean),
// -1 io error, -2 corrupt file, -4 oom.
int64_t pel_repair(const char* path) {
  try {
    std::vector<char> buf;
    if (!read_file(path, &buf)) return -1;
    if (buf.empty()) return 0;
    bool v1 = buf.size() >= 8 && std::memcmp(buf.data(), kMagicV1, 8) == 0;
    std::vector<Rec> recs;
    size_t valid_end;
    int version;
    if (!parse_records(buf, v1 ? &recs : nullptr, &valid_end, &version))
      return -2;
    int64_t dropped = static_cast<int64_t>(buf.size() - valid_end);
    if (version == 1) {
      // keep EVERY parsed record (tombstones and shadowed writes too):
      // repair restores framing invariants, compaction is a policy call
      std::vector<const Rec*> all;
      all.reserve(recs.size());
      for (const Rec& r : recs) all.push_back(&r);
      std::string tmp = std::string(path) + ".upgrade";
      FILE* f = std::fopen(tmp.c_str(), "wb");
      if (!f) return -1;
      bool ok = write_records_v2(f, all);
      ok = ok && std::fflush(f) == 0 && fsync(fileno(f)) == 0;
      ok = (std::fclose(f) == 0) && ok;
      if (!ok || std::rename(tmp.c_str(), path) != 0) {
        std::remove(tmp.c_str());
        return -1;
      }
      return dropped;
    }
    if (valid_end == buf.size()) return 0;
    FILE* f = std::fopen(path, "rb+");
    if (!f) return -1;
    int rc = std::fflush(f) == 0 &&
                     ftruncate(fileno(f), static_cast<off_t>(valid_end)) == 0
                 ? 0
                 : -1;
    std::fclose(f);
    return rc == 0 ? dropped : -1;
  } catch (...) {
    return -4;
  }
}

// Rewrites the log keeping only live records (dropping tombstones and
// records shadowed by a newer write of the same event id), preserving
// order. Atomic: writes <path>.compact then renames over the original.
// Returns bytes reclaimed (0 = nothing to do), -1 io error, -2 corrupt,
// -4 oom.
int64_t pel_compact(const char* path) {
  try {
    std::vector<char> buf;
    if (!read_file(path, &buf)) return -1;
    if (buf.empty()) return 0;
    std::vector<Rec> recs;
    size_t valid_end;
    if (!parse_records(buf, &recs, &valid_end)) return -2;

    std::vector<const Rec*> live;
    collect_live(recs, &live);
    int64_t live_bytes = 8;  // magic
    for (const Rec* r : live) {
      uint64_t payload = kHeaderFixed;
      for (int c = 0; c < kNumStr; ++c) payload += r->len[c];
      live_bytes += 4 + static_cast<int64_t>(payload) + 4;  // len + crc
    }
    int64_t reclaimed = static_cast<int64_t>(buf.size()) - live_bytes;
    if (reclaimed <= 0) return 0;

    std::string tmp = std::string(path) + ".compact";
    FILE* f = std::fopen(tmp.c_str(), "wb");
    if (!f) return -1;
    bool ok = write_records_v2(f, live);
    // fsync BEFORE the rename: fflush only reaches the page cache, and a
    // rename-then-crash could otherwise leave a truncated file where the
    // intact original used to be (append-path fflush bounds loss to one
    // record; a rewrite must not risk the whole log)
    ok = ok && std::fflush(f) == 0 && fsync(fileno(f)) == 0;
    ok = (std::fclose(f) == 0) && ok;
    if (!ok || std::rename(tmp.c_str(), path) != 0) {
      std::remove(tmp.c_str());
      return -1;
    }
    return reclaimed;
  } catch (...) {
    return -4;
  }
}

}  // extern "C"
