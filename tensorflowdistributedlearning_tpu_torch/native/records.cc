// Native TFRecord shard reader: background-threaded file reading, masked-crc32c
// integrity checks, and a shuffle pool — the record-streaming half of the
// tf.data-class C++ input runtime (decode lives in io.cc). The reference
// inherited all of this from TensorFlow's C++ tf.data pipeline (SURVEY §2.2);
// here it is first-party.
//
// TFRecord framing (the public format):
//   uint64 length (LE) | uint32 masked_crc32c(length) | bytes data |
//   uint32 masked_crc32c(data)
// masked_crc = ((crc >> 15) | (crc << 17)) + 0xa282ead8, crc32c (Castagnoli).
//
// C API (ctypes):
//   int64 tfdl_rec_open(const char** paths, int n_paths, int shuffle_buf,
//                       uint64_t seed, int verify_crc)
//   int   tfdl_rec_next(int64 handle, const uint8_t** data, uint64_t* len)
//           -> 1 record, 0 clean end-of-stream, -1 corrupt stream
//   void  tfdl_rec_close(int64 handle)
// The pointer returned by tfdl_rec_next stays valid until the next call on the
// same handle. One producer thread per handle reads ahead into a bounded queue
// (file IO overlaps the caller's decode/augment work); the consumer side keeps
// a shuffle pool of `shuffle_buf` records and emits a uniformly random one per
// call (shard order is itself shuffled by `seed`).
//
// Offset-indexed range reads (the data-service worker read path — records at
// known byte offsets from a shard's .idx sidecar, any order):
//   int64 tfdl_ranges_open(const char* path)
//   int   tfdl_ranges_read(int64 handle, const uint64_t* offsets, int n,
//                          int verify, const uint8_t** datas, uint64_t* lens)
//           -> 0 ok (datas/lens filled), -1 corrupt, -2 io, -3 bad handle
//   void  tfdl_ranges_close(int64 handle)
// Pointers stay valid until the next read/close on the same handle; a handle
// serves ONE caller at a time (each service worker opens its own).
//
// The writer's checksum (the Python writer frames records with it):
//   uint32 tfdl_masked_crc32c(const uint8_t* data, uint64_t len)

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// crc32c (Castagnoli, reflected 0x82f63b78), table-driven.
uint32_t kCrcTable[256];
bool crc_table_init = [] {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0x82f63b78u ^ (c >> 1) : c >> 1;
    kCrcTable[i] = c;
  }
  return true;
}();

uint32_t Crc32c(const uint8_t* data, size_t n) {
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; ++i) c = kCrcTable[(c ^ data[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

uint32_t MaskedCrc(const uint8_t* data, size_t n) {
  uint32_t crc = Crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

struct Reader {
  std::vector<std::string> paths;
  bool verify;
  size_t queue_cap;

  std::thread producer;
  std::mutex mu;
  std::condition_variable cv_pop, cv_push;
  std::deque<std::vector<uint8_t>> queue;
  bool done = false;       // producer finished (or error)
  int error = 0;           // 0 ok, 1 crc/framing corruption, 2 file IO failure
  bool closing = false;    // consumer asked to stop

  std::vector<std::vector<uint8_t>> pool;  // shuffle pool
  std::mt19937_64 rng;
  size_t shuffle_buf;
  std::vector<uint8_t> current;  // buffer handed to the caller

  void Produce() {
    for (const auto& path : paths) {
      FILE* f = std::fopen(path.c_str(), "rb");
      if (!f) {
        SetDone(2);  // IO failure, not corruption
        return;
      }
      while (true) {
        uint8_t header[12];
        size_t got = std::fread(header, 1, 12, f);
        if (got == 0) break;  // clean end of shard
        if (got != 12) {
          std::fclose(f);
          SetDone(1);
          return;
        }
        uint64_t len;
        std::memcpy(&len, header, 8);
        // length sanity is NOT optional: a garbage 64-bit length would make the
        // vector allocation below throw in this background thread -> terminate
        if (len > (1ull << 31)) {
          std::fclose(f);
          SetDone(1);
          return;
        }
        if (verify) {
          uint32_t want;
          std::memcpy(&want, header + 8, 4);
          if (MaskedCrc(header, 8) != want) {
            std::fclose(f);
            SetDone(1);
            return;
          }
        }
        std::vector<uint8_t> rec(len);
        uint8_t footer[4];
        if (std::fread(rec.data(), 1, len, f) != len ||
            std::fread(footer, 1, 4, f) != 4) {
          std::fclose(f);
          SetDone(1);
          return;
        }
        if (verify) {
          uint32_t want;
          std::memcpy(&want, footer, 4);
          if (MaskedCrc(rec.data(), len) != want) {
            std::fclose(f);
            SetDone(1);
            return;
          }
        }
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return queue.size() < queue_cap || closing; });
        if (closing) {
          std::fclose(f);
          return;
        }
        queue.push_back(std::move(rec));
        cv_pop.notify_one();
      }
      std::fclose(f);
    }
    SetDone(0);
  }

  void SetDone(int err) {
    std::lock_guard<std::mutex> lk(mu);
    done = true;
    error = err;
    cv_pop.notify_all();
  }

  // Pop one record from the queue; false on end-of-stream/error.
  bool Pop(std::vector<uint8_t>* out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_pop.wait(lk, [&] { return !queue.empty() || done; });
    if (queue.empty()) return false;
    *out = std::move(queue.front());
    queue.pop_front();
    cv_push.notify_one();
    return true;
  }

  // 1 = record in `current`, 0 = end, -1 = corruption, -2 = file IO failure.
  int Next() {
    // top up the shuffle pool
    while (pool.size() < shuffle_buf) {
      std::vector<uint8_t> rec;
      if (!Pop(&rec)) break;
      pool.push_back(std::move(rec));
    }
    if (pool.empty()) {
      std::lock_guard<std::mutex> lk(mu);
      return error ? -error : 0;
    }
    size_t idx =
        shuffle_buf > 1 ? std::uniform_int_distribution<size_t>(0, pool.size() - 1)(rng)
                        : 0;
    current = std::move(pool[idx]);
    pool[idx] = std::move(pool.back());
    pool.pop_back();
    return 1;
  }
};

std::mutex g_mu;
std::unordered_map<int64_t, Reader*> g_readers;
int64_t g_next_handle = 1;

// One shard file opened for random-access record reads. The byte storage for
// the latest read call lives on the handle, so returned pointers stay valid
// until the next call — the same lifetime contract as tfdl_rec_next.
struct RangeReader {
  FILE* f = nullptr;
  std::vector<std::vector<uint8_t>> recs;
};

std::mutex g_range_mu;
std::unordered_map<int64_t, RangeReader*> g_range_readers;
int64_t g_next_range_handle = 1;

}  // namespace

extern "C" {

int64_t tfdl_rec_open(const char** paths, int n_paths, int shuffle_buf,
                      uint64_t seed, int verify_crc) {
  if (n_paths <= 0) return 0;
  auto* r = new Reader();
  r->paths.assign(paths, paths + n_paths);
  std::mt19937_64 order_rng(seed);
  std::shuffle(r->paths.begin(), r->paths.end(), order_rng);
  r->rng.seed(seed ^ 0x9e3779b97f4a7c15ull);
  r->shuffle_buf = shuffle_buf > 0 ? static_cast<size_t>(shuffle_buf) : 1;
  r->queue_cap = r->shuffle_buf + 1024;
  r->verify = verify_crc != 0;
  r->producer = std::thread([r] { r->Produce(); });
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next_handle++;
  g_readers[h] = r;
  return h;
}

int tfdl_rec_next(int64_t handle, const uint8_t** data, uint64_t* len) {
  Reader* r;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_readers.find(handle);
    // -3 = unknown/closed handle (a caller lifecycle bug), distinct from the
    // -1 corruption and -2 IO codes so the binding can raise the right error
    if (it == g_readers.end()) return -3;
    r = it->second;
  }
  int rc = r->Next();
  if (rc == 1) {
    *data = r->current.data();
    *len = r->current.size();
  } else {
    *data = nullptr;
    *len = 0;
  }
  return rc;
}

void tfdl_rec_close(int64_t handle) {
  Reader* r = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_readers.find(handle);
    if (it == g_readers.end()) return;
    r = it->second;
    g_readers.erase(it);
  }
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->closing = true;
    r->cv_push.notify_all();
  }
  if (r->producer.joinable()) r->producer.join();
  delete r;
}

int64_t tfdl_ranges_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 0;
  auto* r = new RangeReader();
  r->f = f;
  std::lock_guard<std::mutex> lk(g_range_mu);
  int64_t h = g_next_range_handle++;
  g_range_readers[h] = r;
  return h;
}

int tfdl_ranges_read(int64_t handle, const uint64_t* offsets, int n,
                     int verify, const uint8_t** datas, uint64_t* lens) {
  RangeReader* r;
  {
    std::lock_guard<std::mutex> lk(g_range_mu);
    auto it = g_range_readers.find(handle);
    if (it == g_range_readers.end()) return -3;
    r = it->second;
  }
  r->recs.clear();
  r->recs.reserve(n);
  for (int i = 0; i < n; ++i) {
    // a PRIOR call's transient error must not make this call's clean short
    // reads (real truncation) look like retryable I/O — handles are cached
    // and reused across retries
    std::clearerr(r->f);
    if (fseeko(r->f, static_cast<off_t>(offsets[i]), SEEK_SET) != 0) return -2;
    uint8_t header[12];
    if (std::fread(header, 1, 12, r->f) != 12) {
      // ferror = transient I/O (retryable -2, like the Python fallback's
      // OSError); clean short read = truncated framing / bad offset (-1)
      return std::ferror(r->f) ? -2 : -1;
    }
    uint64_t len;
    std::memcpy(&len, header, 8);
    if (len > (1ull << 31)) return -1;  // garbage length: wrong offset/corrupt
    if (verify) {
      uint32_t want;
      std::memcpy(&want, header + 8, 4);
      if (MaskedCrc(header, 8) != want) return -1;
    }
    std::vector<uint8_t> rec;
    try {
      rec.resize(len);
    } catch (const std::bad_alloc&) {
      // with verify=0 a mid-record offset's garbage length can pass the
      // 2^31 guard; an exception must not cross the extern "C" boundary
      // (std::terminate) — report it as the corruption it is
      return -1;
    }
    uint8_t footer[4];
    if (std::fread(rec.data(), 1, len, r->f) != len ||
        std::fread(footer, 1, 4, r->f) != 4) {
      return std::ferror(r->f) ? -2 : -1;
    }
    if (verify) {
      uint32_t want;
      std::memcpy(&want, footer, 4);
      if (MaskedCrc(rec.data(), len) != want) return -1;
    }
    r->recs.push_back(std::move(rec));
    datas[i] = r->recs.back().data();
    lens[i] = r->recs.back().size();
  }
  return 0;
}

void tfdl_ranges_close(int64_t handle) {
  RangeReader* r = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_range_mu);
    auto it = g_range_readers.find(handle);
    if (it == g_range_readers.end()) return;
    r = it->second;
    g_range_readers.erase(it);
  }
  std::fclose(r->f);
  delete r;
}

uint32_t tfdl_masked_crc32c(const uint8_t* data, uint64_t len) {
  return MaskedCrc(data, static_cast<size_t>(len));
}

}  // extern "C"
