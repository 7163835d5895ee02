// Native episode-shard writer: multithreaded deflate into a standard
// ``.npz`` (ZIP of ``.npy`` members), readable by ``np.load``.
//
// The datagen runtime component the reference only implies (zarr pinned in
// pixi.toml:21 but no storage code ships — SURVEY.md §5 checkpoint/resume):
// at thousands of observation frames per second per chip, Python's
// single-threaded ``np.savez_compressed`` becomes the host-side bottleneck
// of the teleop/rollout recording loop.  Members are compressed in parallel
// worker threads, then the ZIP is assembled sequentially.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread recorder.cpp -lz -o _rec.so

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

#pragma pack(push, 1)
struct LocalHeader {
  uint32_t sig = 0x04034b50;
  uint16_t version = 20, flags = 0, method;  // 8 = deflate, 0 = store
  uint16_t mtime = 0, mdate = 0x21;          // dummy DOS date
  uint32_t crc, csize, usize;
  uint16_t name_len, extra_len = 0;
};
struct CentralHeader {
  uint32_t sig = 0x02014b50;
  uint16_t made_by = 20, version = 20, flags = 0, method;
  uint16_t mtime = 0, mdate = 0x21;
  uint32_t crc, csize, usize;
  uint16_t name_len, extra_len = 0, comment_len = 0, disk = 0;
  uint16_t int_attr = 0;
  uint32_t ext_attr = 0, offset;
};
struct EndRecord {
  uint32_t sig = 0x06054b50;
  uint16_t disk = 0, cd_disk = 0, n_disk, n_total;
  uint32_t cd_size, cd_offset;
  uint16_t comment_len = 0;
};
#pragma pack(pop)

// ``.npy`` v1.0 header for a C-contiguous array
std::string npy_header(const char *descr, const int64_t *shape, int64_t ndim) {
  std::string dict = "{'descr': '";
  dict += descr;
  dict += "', 'fortran_order': False, 'shape': (";
  for (int64_t i = 0; i < ndim; ++i) {
    dict += std::to_string(shape[i]);
    if (ndim == 1 || i + 1 < ndim) dict += ",";
    if (i + 1 < ndim) dict += " ";
  }
  dict += "), }";
  size_t total = 10 + dict.size() + 1;           // magic+ver+len, dict, \n
  size_t pad = (64 - total % 64) % 64;
  dict += std::string(pad, ' ');
  dict += '\n';
  std::string h = "\x93NUMPY";
  h += '\x01';
  h += '\x00';
  uint16_t hl = (uint16_t)dict.size();
  h += (char)(hl & 0xff);
  h += (char)(hl >> 8);
  h += dict;
  return h;
}

struct Member {
  std::string name;           // "key.npy"
  std::string payload_head;   // npy header
  const uint8_t *data;
  int64_t nbytes;
  // filled by the compression worker:
  std::vector<uint8_t> compressed;
  uint32_t crc = 0;
  bool deflated = false;
};

void compress_member(Member &m, int level) {
  uint64_t usize = m.payload_head.size() + (uint64_t)m.nbytes;
  m.crc = crc32(0, (const Bytef *)m.payload_head.data(),
                (uInt)m.payload_head.size());
  // crc over large data in chunks (crc32 takes uInt lengths)
  for (int64_t off = 0; off < m.nbytes; off += 1 << 30)
    m.crc = crc32(m.crc, m.data + off,
                  (uInt)std::min<int64_t>(m.nbytes - off, 1 << 30));
  if (level <= 0 || usize > 0xfffff000ULL) {    // store (or zip32 overflow)
    m.deflated = false;
    return;
  }
  z_stream zs{};
  deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY);  // raw
  m.compressed.resize(deflateBound(&zs, (uLong)usize));
  zs.next_out = m.compressed.data();
  zs.avail_out = (uInt)m.compressed.size();
  zs.next_in = (Bytef *)m.payload_head.data();
  zs.avail_in = (uInt)m.payload_head.size();
  deflate(&zs, m.nbytes == 0 ? Z_FINISH : Z_NO_FLUSH);
  for (int64_t off = 0; off < m.nbytes; off += 1 << 30) {
    zs.next_in = (Bytef *)(m.data + off);
    zs.avail_in = (uInt)std::min<int64_t>(m.nbytes - off, 1 << 30);
    deflate(&zs, off + (1 << 30) >= m.nbytes ? Z_FINISH : Z_NO_FLUSH);
  }
  m.compressed.resize(zs.total_out);
  deflateEnd(&zs);
  // compression must pay for itself AND fit zip32
  uint64_t csize = m.compressed.size();
  m.deflated = csize < usize && csize <= 0xfffff000ULL;
  if (!m.deflated) m.compressed.clear();
}

}  // namespace

extern "C" {

// Write one .npz shard.  names/descrs are per-member; shapes is the
// concatenation of all members' dims (ndims[i] each).  level: zlib 0-9
// (0 = store).  Returns 0 on success, negative errno-style codes on error.
int64_t sas_npz_write(const char *path, int64_t n, const char **names,
                      const char **descrs, const int64_t *ndims,
                      const int64_t *shapes, const void **data,
                      const int64_t *nbytes, int32_t level) {
  std::vector<Member> members((size_t)n);
  const int64_t *sp = shapes;
  for (int64_t i = 0; i < n; ++i) {
    members[i].name = std::string(names[i]) + ".npy";
    members[i].payload_head = npy_header(descrs[i], sp, ndims[i]);
    sp += ndims[i];
    members[i].data = (const uint8_t *)data[i];
    members[i].nbytes = nbytes[i];
  }

  unsigned hw = std::thread::hardware_concurrency();
  int64_t nt = std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1, n));
  std::vector<std::thread> ts;
  for (int64_t t = 0; t < nt; ++t)
    ts.emplace_back([&, t]() {
      for (int64_t i = t; i < n; i += nt) compress_member(members[i], level);
    });
  for (auto &t : ts) t.join();

  FILE *f = std::fopen(path, "wb");
  if (!f) return -1;
  std::vector<uint32_t> offsets((size_t)n);
  uint64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    Member &m = members[i];
    uint64_t usize = m.payload_head.size() + (uint64_t)m.nbytes;
    uint64_t csize = m.deflated ? m.compressed.size() : usize;
    if (pos + csize + 128 > 0xfffff000ULL) { std::fclose(f); return -2; }
    offsets[i] = (uint32_t)pos;
    LocalHeader lh;
    lh.method = m.deflated ? 8 : 0;
    lh.crc = m.crc;
    lh.csize = (uint32_t)csize;
    lh.usize = (uint32_t)usize;
    lh.name_len = (uint16_t)m.name.size();
    std::fwrite(&lh, sizeof lh, 1, f);
    std::fwrite(m.name.data(), 1, m.name.size(), f);
    if (m.deflated) {
      std::fwrite(m.compressed.data(), 1, m.compressed.size(), f);
    } else {
      std::fwrite(m.payload_head.data(), 1, m.payload_head.size(), f);
      std::fwrite(m.data, 1, (size_t)m.nbytes, f);
    }
    pos += sizeof lh + m.name.size() + csize;
  }
  uint64_t cd_start = pos;
  for (int64_t i = 0; i < n; ++i) {
    Member &m = members[i];
    uint64_t usize = m.payload_head.size() + (uint64_t)m.nbytes;
    CentralHeader ch;
    ch.method = m.deflated ? 8 : 0;
    ch.crc = m.crc;
    ch.csize = m.deflated ? (uint32_t)m.compressed.size() : (uint32_t)usize;
    ch.usize = (uint32_t)usize;
    ch.name_len = (uint16_t)m.name.size();
    ch.offset = offsets[i];
    std::fwrite(&ch, sizeof ch, 1, f);
    std::fwrite(m.name.data(), 1, m.name.size(), f);
    pos += sizeof ch + m.name.size();
  }
  EndRecord er;
  er.n_disk = er.n_total = (uint16_t)n;
  er.cd_size = (uint32_t)(pos - cd_start);
  er.cd_offset = (uint32_t)cd_start;
  std::fwrite(&er, sizeof er, 1, f);
  int rc = std::fclose(f);
  return rc == 0 ? 0 : -3;
}

}  // extern "C"
