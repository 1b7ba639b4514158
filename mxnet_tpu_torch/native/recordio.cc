// RecordIO: length-prefixed binary record container, byte-compatible with the
// reference's dmlc recordio framing (python/mxnet/recordio.py MXRecordIO over
// dmlc-core recordio): records are
//     [kMagic:u32][lrecord:u32][payload][pad to 4B]
// where lrecord packs cflag (upper 3 bits, 0 for whole records) and length
// (lower 29 bits). IndexedRecordIO adds a text .idx of "key\toffset" lines.
//
// Re-implemented from the published on-disk format (not a code port); C ABI
// for ctypes.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

inline uint32_t EncodeL(uint32_t cflag, uint32_t len) {
  return (cflag << 29u) | (len & ((1u << 29u) - 1u));
}
inline uint32_t DecodeFlag(uint32_t l) { return l >> 29u; }
inline uint32_t DecodeLen(uint32_t l) { return l & ((1u << 29u) - 1u); }

struct Writer {
  FILE* f = nullptr;
};

struct Reader {
  FILE* f = nullptr;
  std::vector<char> buf;
};

}  // namespace

extern "C" {

void* mxtpu_recio_writer_open(const char* path) {
  auto* w = new Writer();
  w->f = std::fopen(path, "wb");
  if (!w->f) {
    delete w;
    return nullptr;
  }
  return w;
}

// returns byte offset of the record start (for the index), or -1 on error
int64_t mxtpu_recio_write(void* vw, const char* data, int64_t len) {
  auto* w = static_cast<Writer*>(vw);
  int64_t pos = std::ftell(w->f);
  uint32_t magic = kMagic;
  uint32_t lrec = EncodeL(0, static_cast<uint32_t>(len));
  if (std::fwrite(&magic, 4, 1, w->f) != 1) return -1;
  if (std::fwrite(&lrec, 4, 1, w->f) != 1) return -1;
  if (len && std::fwrite(data, 1, len, w->f) != static_cast<size_t>(len))
    return -1;
  size_t pad = (4 - (len & 3)) & 3;
  uint32_t zero = 0;
  if (pad && std::fwrite(&zero, 1, pad, w->f) != pad) return -1;
  return pos;
}

void mxtpu_recio_writer_close(void* vw) {
  auto* w = static_cast<Writer*>(vw);
  if (w->f) std::fclose(w->f);
  delete w;
}

void* mxtpu_recio_reader_open(const char* path) {
  auto* r = new Reader();
  r->f = std::fopen(path, "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  return r;
}

// read next record; returns length (>=0), -1 at EOF, -2 on corrupt stream.
// *out points into an internal buffer valid until the next call.
int64_t mxtpu_recio_read(void* vr, const char** out) {
  auto* r = static_cast<Reader*>(vr);
  uint32_t magic = 0, lrec = 0;
  if (std::fread(&magic, 4, 1, r->f) != 1) return -1;
  if (magic != kMagic) return -2;
  if (std::fread(&lrec, 4, 1, r->f) != 1) return -2;
  uint32_t len = DecodeLen(lrec);
  r->buf.resize(len);
  if (len && std::fread(r->buf.data(), 1, len, r->f) != len) return -2;
  size_t pad = (4 - (len & 3)) & 3;
  if (pad) std::fseek(r->f, static_cast<long>(pad), SEEK_CUR);
  *out = r->buf.data();
  return len;
}

void mxtpu_recio_seek(void* vr, int64_t offset) {
  std::fseek(static_cast<Reader*>(vr)->f, static_cast<long>(offset), SEEK_SET);
}

int64_t mxtpu_recio_tell(void* vr) {
  return std::ftell(static_cast<Reader*>(vr)->f);
}

void mxtpu_recio_reader_close(void* vr) {
  auto* r = static_cast<Reader*>(vr);
  if (r->f) std::fclose(r->f);
  delete r;
}

}  // extern "C"
