// Native RecordIO reader of the PyTorch/CUDA port: the port's own copy of
// cpp/recordio.cc (reference: dmlc-core/src/recordio.cc +
// include/dmlc/recordio.h, re-designed, not translated: mmap + one upfront
// offset index instead of dmlc's stream splitter, because the consumer is
// a Python DataLoader that wants zero-copy random access), built by
// mxnet_tpu_torch/recordio.py with g++ into mxnet_tpu_torch/_build/.
//
// Format (shared with mxnet_tpu_torch/recordio.py and the JAX package):
//   record := [u32 kMagic][u32 lrec][payload][pad to 4B]
//   lrec   := (cflag << 29) | length ; cflag 0 whole, 1/2/3 multi-part
//
// C ABI (ctypes-consumed by mxnet_tpu_torch/recordio.py):
//   MXTPURecOpen(path)            -> handle (nullptr on error)
//   MXTPURecCount(h)              -> int64 number of logical records
//   MXTPURecGet(h, i, &ptr, &len) -> 0 ok / -1 bad index / 1 multipart
//       (ptr points INTO the mmap for single-part records: zero copy)
//   MXTPURecGetCopy(h, i, buf, cap) -> bytes written or <0 (handles
//       multi-part by stitching; call with buf=null to query size)
//   MXTPURecClose(h)
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint32_t kLenMask = (1u << 29) - 1;

struct Part {
  uint64_t off;   // payload offset in file
  uint32_t len;   // payload length
};

struct Record {
  std::vector<Part> parts;  // 1 part for cflag==0 records
  uint64_t total = 0;
};

struct RecFile {
  int fd = -1;
  const uint8_t* base = nullptr;
  uint64_t size = 0;
  std::vector<Record> records;
};

bool BuildIndex(RecFile* f) {
  uint64_t pos = 0;
  Record cur;
  bool in_multi = false;
  while (pos + 8 <= f->size) {
    uint32_t magic, lrec;
    std::memcpy(&magic, f->base + pos, 4);
    std::memcpy(&lrec, f->base + pos + 4, 4);
    if (magic != kMagic) return false;
    const uint32_t cflag = lrec >> 29;
    const uint32_t len = lrec & kLenMask;
    const uint64_t payload = pos + 8;
    if (payload + len > f->size) return false;
    switch (cflag) {
      case 0:
        if (in_multi) return false;
        f->records.push_back({{{payload, len}}, len});
        break;
      case 1:
        if (in_multi) return false;
        in_multi = true;
        cur = Record();
        cur.parts.push_back({payload, len});
        cur.total = len;
        break;
      case 2:
      case 3:
        if (!in_multi) return false;
        cur.parts.push_back({payload, len});
        cur.total += len;
        if (cflag == 3) {
          f->records.push_back(std::move(cur));
          in_multi = false;
        }
        break;
      default:
        return false;
    }
    pos = payload + len + ((4 - len % 4) % 4);
  }
  return !in_multi && pos == f->size;
}

}  // namespace

extern "C" {

void* MXTPURecOpen(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  auto* f = new RecFile();
  f->fd = fd;
  f->size = static_cast<uint64_t>(st.st_size);
  if (f->size > 0) {
    void* m = mmap(nullptr, f->size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) {
      ::close(fd);
      delete f;
      return nullptr;
    }
    f->base = static_cast<const uint8_t*>(m);
    // the DataLoader reads records in roughly ascending order
    madvise(m, f->size, MADV_WILLNEED);
  }
  if (!BuildIndex(f)) {
    if (f->base) munmap(const_cast<uint8_t*>(f->base), f->size);
    ::close(fd);
    delete f;
    return nullptr;
  }
  return f;
}

int64_t MXTPURecCount(void* h) {
  return static_cast<RecFile*>(h)->records.size();
}

int MXTPURecGet(void* h, int64_t i, const uint8_t** ptr, uint64_t* len) {
  auto* f = static_cast<RecFile*>(h);
  if (i < 0 || static_cast<uint64_t>(i) >= f->records.size()) return -1;
  const Record& r = f->records[i];
  if (r.parts.size() != 1) return 1;  // multipart: use MXTPURecGetCopy
  *ptr = f->base + r.parts[0].off;
  *len = r.parts[0].len;
  return 0;
}

int64_t MXTPURecGetCopy(void* h, int64_t i, uint8_t* buf, uint64_t cap) {
  auto* f = static_cast<RecFile*>(h);
  if (i < 0 || static_cast<uint64_t>(i) >= f->records.size()) return -1;
  const Record& r = f->records[i];
  if (buf == nullptr) return static_cast<int64_t>(r.total);
  if (cap < r.total) return -2;
  uint64_t w = 0;
  for (const Part& p : r.parts) {
    std::memcpy(buf + w, f->base + p.off, p.len);
    w += p.len;
  }
  return static_cast<int64_t>(w);
}

void MXTPURecClose(void* h) {
  auto* f = static_cast<RecFile*>(h);
  if (f->base) munmap(const_cast<uint8_t*>(f->base), f->size);
  if (f->fd >= 0) ::close(f->fd);
  delete f;
}

}  // extern "C"
