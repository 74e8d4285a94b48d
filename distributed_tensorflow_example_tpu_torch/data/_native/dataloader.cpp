// Native data loader of the PyTorch port (a copy of
// distributed_tensorflow_example_tpu/data/_native/dataloader.cpp, built by
// data/native.py with g++ into build/native/ at the repository root).
//
// Worker threads gather example rows into ready batch buffers in a bounded
// ring, so batch assembly overlaps the step and runs off the Python GIL.
//
// Division of labor with the Python layer (data/native.py):
//   - Python owns the dataset arrays and the determinism contract: each
//     epoch's order comes from numpy (the ShardedLoader's permutation and
//     per-process slice), so the native and Python loaders yield the same
//     batch sequence bit for bit.
//   - C++ owns the bytes: IDX/CIFAR file parsing, order-driven row
//     gather, batch assembly, the prefetch ring, thread lifecycle.
//
// C API (ctypes-friendly): every function is extern "C"; handles are opaque
// pointers; errors are negative return codes (no exceptions cross the ABI).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// File parsing: IDX (MNIST) and CIFAR-10 binary
// ---------------------------------------------------------------------------

static uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// Query an IDX image file: fills dims[0..2] = {n, rows, cols}. Returns 0 on
// success, negative on error.
int dl_idx_image_dims(const char* path, int64_t dims[3]) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[16];
  if (fread(hdr, 1, 16, f) != 16) { fclose(f); return -2; }
  fclose(f);
  if (be32(hdr) != 2051) return -3;  // image magic
  dims[0] = be32(hdr + 4);
  dims[1] = be32(hdr + 8);
  dims[2] = be32(hdr + 12);
  return 0;
}

// Read IDX images into out (n*rows*cols bytes, caller-allocated).
int dl_idx_read_images(const char* path, unsigned char* out, int64_t out_size) {
  int64_t dims[3];
  int rc = dl_idx_image_dims(path, dims);
  if (rc) return rc;
  int64_t want = dims[0] * dims[1] * dims[2];
  if (out_size < want) return -4;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 16, SEEK_SET);
  int64_t got = (int64_t)fread(out, 1, (size_t)want, f);
  fclose(f);
  return got == want ? 0 : -5;
}

int dl_idx_label_count(const char* path, int64_t* n) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[8];
  if (fread(hdr, 1, 8, f) != 8) { fclose(f); return -2; }
  fclose(f);
  if (be32(hdr) != 2049) return -3;  // label magic
  *n = be32(hdr + 4);
  return 0;
}

int dl_idx_read_labels(const char* path, unsigned char* out, int64_t out_size) {
  int64_t n;
  int rc = dl_idx_label_count(path, &n);
  if (rc) return rc;
  if (out_size < n) return -4;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 8, SEEK_SET);
  int64_t got = (int64_t)fread(out, 1, (size_t)n, f);
  fclose(f);
  return got == n ? 0 : -5;
}

// CIFAR-10 binary: records of 1 label byte + 3072 pixel bytes (CHW planar).
// Parses into NHWC float32 [n,32,32,3] scaled to [0,1] + int32 labels —
// the exact output of the numpy parser (x / 255 in f32, correctly rounded;
// the reference's copy multiplies by 1/255 and misses it by an ulp),
// computed here without the transpose/copy chain numpy needs.
int dl_cifar_record_count(const char* path, int64_t* n) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fclose(f);
  if (sz % 3073) return -3;
  *n = sz / 3073;
  return 0;
}

int dl_cifar_read(const char* path, float* out_x, int32_t* out_y,
                  int64_t capacity_records) {
  int64_t n;
  int rc = dl_cifar_record_count(path, &n);
  if (rc) return rc;
  if (capacity_records < n) return -4;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<unsigned char> rec(3073);
  for (int64_t i = 0; i < n; ++i) {
    if (fread(rec.data(), 1, 3073, f) != 3073) { fclose(f); return -5; }
    out_y[i] = rec[0];
    float* dst = out_x + i * 32 * 32 * 3;
    const unsigned char* r = rec.data() + 1;
    const unsigned char* g = r + 1024;
    const unsigned char* b = g + 1024;
    for (int p = 0; p < 1024; ++p) {       // CHW planar -> NHWC
      dst[p * 3 + 0] = r[p] / 255.0f;
      dst[p * 3 + 1] = g[p] / 255.0f;
      dst[p * 3 + 2] = b[p] / 255.0f;
    }
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// TFRecord container (the tf.python_io / tf.io on-disk format)
// ---------------------------------------------------------------------------
// Per record: u64le length | u32le masked_crc32c(length bytes)
//           | data bytes   | u32le masked_crc32c(data).
// CRC is CRC-32C (Castagnoli, reflected poly 0x82f63b78);
// mask(c) = rotr(c,15) + 0xa282ead8. C++ owns the byte scan (index +
// integrity check off the GIL); Python (data/tfrecord.py) owns record
// framing, the writer, and the Example proto codec.

static uint32_t kCrcTable[8][256];
static std::atomic<bool> g_crc_ready{false};
static std::mutex g_crc_mu;

static void crc32c_init() {
  if (g_crc_ready.load(std::memory_order_acquire)) return;
  std::lock_guard<std::mutex> lk(g_crc_mu);
  if (g_crc_ready.load(std::memory_order_relaxed)) return;
  const uint32_t poly = 0x82f63b78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
    kCrcTable[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      kCrcTable[t][i] =
          (kCrcTable[t - 1][i] >> 8) ^ kCrcTable[0][kCrcTable[t - 1][i] & 0xff];
  g_crc_ready.store(true, std::memory_order_release);
}

// Slicing-by-8 CRC-32C (little-endian host, as x86-64 is).
uint32_t dl_crc32c(const unsigned char* p, int64_t n) {
  crc32c_init();
  uint32_t c = 0xffffffffu;
  while (n >= 8) {
    uint64_t w;
    memcpy(&w, p, 8);
    w ^= c;
    c = kCrcTable[7][w & 0xff] ^ kCrcTable[6][(w >> 8) & 0xff] ^
        kCrcTable[5][(w >> 16) & 0xff] ^ kCrcTable[4][(w >> 24) & 0xff] ^
        kCrcTable[3][(w >> 32) & 0xff] ^ kCrcTable[2][(w >> 40) & 0xff] ^
        kCrcTable[1][(w >> 48) & 0xff] ^ kCrcTable[0][(w >> 56) & 0xff];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) c = (c >> 8) ^ kCrcTable[0][(c ^ *p++) & 0xff];
  return c ^ 0xffffffffu;
}

static uint32_t mask_crc(uint32_t c) {
  return ((c >> 15) | (c << 17)) + 0xa282ead8u;
}

// Scan a TFRecord file. Returns the record count (>=0) or a negative
// error: -1 open, -2 truncated header, -3 bad length crc, -4 truncated
// data, -5 bad data crc, -6 capacity too small. offsets/lengths (both
// null for a count-only pass) receive each record's DATA offset/length.
// verify != 0 checks both CRCs per record.
int64_t dl_tfrecord_index(const char* path, int64_t* offsets,
                          int64_t* lengths, int64_t capacity, int verify) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  int64_t fsize = (int64_t)ftell(f);
  fseek(f, 0, SEEK_SET);
  int64_t count = 0;
  std::vector<unsigned char> buf;
  unsigned char hdr[12];
  for (;;) {
    size_t got = fread(hdr, 1, 12, f);
    if (got == 0) break;                       // clean EOF
    if (got != 12) { fclose(f); return -2; }
    uint64_t len;
    memcpy(&len, hdr, 8);
    if (verify) {
      uint32_t want;
      memcpy(&want, hdr + 8, 4);
      if (mask_crc(dl_crc32c(hdr, 8)) != want) { fclose(f); return -3; }
    }
    // bound-check in unsigned space: a corrupt length with the high bit
    // set must hit -4, not wrap negative and pass (then fseek backwards
    // and loop forever)
    int64_t data_off = (int64_t)ftell(f);
    if (fsize - data_off < 4 || len > (uint64_t)(fsize - data_off - 4)) {
      fclose(f);
      return -4;
    }
    if (offsets && lengths) {
      if (count >= capacity) { fclose(f); return -6; }
      offsets[count] = data_off;
      lengths[count] = (int64_t)len;
    }
    if (verify) {
      buf.resize(len);
      if (len && fread(buf.data(), 1, (size_t)len, f) != len) {
        fclose(f);
        return -4;
      }
      unsigned char fc[4];
      if (fread(fc, 1, 4, f) != 4) { fclose(f); return -4; }
      uint32_t want;
      memcpy(&want, fc, 4);
      if (mask_crc(dl_crc32c(buf.data(), (int64_t)len)) != want) {
        fclose(f);
        return -5;
      }
    } else {
      fseek(f, (long)(len + 4), SEEK_CUR);
    }
    ++count;
  }
  fclose(f);
  return count;
}

// ---------------------------------------------------------------------------
// Threaded batch-assembly ring
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<std::vector<unsigned char>> bufs;  // one buffer per array
  int64_t seq = -1;               // batch sequence number held in this slot
  std::atomic<bool> ready{false};
};

struct DLoader {
  std::vector<const unsigned char*> datas;  // borrowed (numpy-owned); the
                                            // batch layout is N parallel
                                            // arrays (BERT batches carry 6)
  std::vector<int64_t> rows;                // bytes per example row, per array
  int64_t n_rows;
  int64_t batch;                  // examples per (local) batch
  int depth;                      // ring depth
  int workers;

  std::vector<int64_t> perm;      // current epoch permutation (global order)
  int64_t n_batches = 0;          // batches per epoch

  std::vector<Slot> slots;
  std::atomic<int64_t> next_to_fill{0};   // batch seq workers claim
  int64_t next_to_serve = 0;               // batch seq consumer expects
  std::atomic<bool> stop{false};
  std::atomic<int64_t> epoch_end{0};      // total batches available so far
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::vector<std::thread> threads;

  void fill(int64_t seq) {
    Slot& s = slots[seq % depth];
    const int64_t base = (seq % n_batches) * batch;
    for (int64_t i = 0; i < batch; ++i) {
      int64_t src = perm[base + i];
      for (size_t a = 0; a < datas.size(); ++a)
        memcpy(s.bufs[a].data() + i * rows[a], datas[a] + src * rows[a],
               (size_t)rows[a]);
    }
    {
      // publish under the lock so a waiter between predicate-check and
      // wait cannot miss the notify
      std::lock_guard<std::mutex> lk(mu);
      s.seq = seq;
      s.ready.store(true, std::memory_order_release);
    }
    cv_ready.notify_all();
  }

  void worker() {
    while (!stop.load(std::memory_order_acquire)) {
      int64_t seq = next_to_fill.load(std::memory_order_relaxed);
      // claim work only within the released window and ring capacity
      if (seq >= epoch_end.load(std::memory_order_acquire) ||
          seq >= next_to_serve_snapshot() + depth) {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait_for(lk, std::chrono::milliseconds(50));
        continue;
      }
      if (!next_to_fill.compare_exchange_strong(seq, seq + 1)) continue;
      // slot must be free (consumer released it)
      Slot& s = slots[seq % depth];
      while (s.ready.load(std::memory_order_acquire) &&
             !stop.load(std::memory_order_acquire)) {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait_for(lk, std::chrono::milliseconds(50));
      }
      if (stop.load(std::memory_order_acquire)) return;
      fill(seq);
    }
  }

  int64_t next_to_serve_snapshot() {
    std::lock_guard<std::mutex> lk(mu);
    return next_to_serve;
  }
};

// Create a loader over N borrowed row-major arrays (the batch dict's
// arrays in a fixed key order — any layout, e.g. BERT's 6-array batches).
// local batch only — the process's shard of the global batch; sharding
// policy stays in Python.
DLoader* dl_create(const unsigned char* const* arrays, const int64_t* row_bytes,
                   int n_arrays, int64_t n_rows, int64_t batch, int depth,
                   int workers) {
  if (!arrays || !row_bytes || n_arrays <= 0 || batch <= 0 || depth <= 0 ||
      n_rows < batch)
    return nullptr;
  for (int a = 0; a < n_arrays; ++a)
    if (!arrays[a] || row_bytes[a] <= 0) return nullptr;
  auto* L = new DLoader();
  L->datas.assign(arrays, arrays + n_arrays);
  L->rows.assign(row_bytes, row_bytes + n_arrays);
  L->n_rows = n_rows; L->batch = batch;
  L->depth = depth; L->workers = workers > 0 ? workers : 2;
  L->slots = std::vector<Slot>(depth);
  for (auto& s : L->slots) {
    s.bufs.resize(n_arrays);
    for (int a = 0; a < n_arrays; ++a)
      s.bufs[a].resize((size_t)(batch * row_bytes[a]));
  }
  for (int i = 0; i < L->workers; ++i)
    L->threads.emplace_back([L] { L->worker(); });
  return L;
}

// Install the next epoch's permutation (length must be a multiple of batch;
// Python truncates to full batches — drop_remainder semantics). Extends the
// released window by perm_len/batch batches.
int dl_set_epoch(DLoader* L, const int64_t* perm, int64_t perm_len) {
  if (!L || perm_len % L->batch) return -1;
  for (int64_t i = 0; i < perm_len; ++i)
    if (perm[i] < 0 || perm[i] >= L->n_rows) return -2;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->perm.assign(perm, perm + perm_len);
    L->n_batches = perm_len / L->batch;
    // serving position continues; window extends one epoch
    L->epoch_end.store(
        ((L->epoch_end.load() / L->n_batches) + 1) * L->n_batches,
        std::memory_order_release);
  }
  L->cv_free.notify_all();
  return 0;
}

// Blocking: acquire pointers to the next assembled batch — out_ptrs must
// have room for n_arrays pointers. Caller must call dl_release before the
// slot can be refilled. Returns 0, or -1 on shutdown, -2 when no epoch is
// installed.
int dl_acquire(DLoader* L, unsigned char** out_ptrs) {
  if (!L) return -1;
  if (L->epoch_end.load() == 0) return -2;
  Slot& s = L->slots[L->next_to_serve % L->depth];
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] {
    return L->stop.load() ||
           (s.ready.load(std::memory_order_acquire) &&
            s.seq == L->next_to_serve);
  });
  if (L->stop.load()) return -1;
  for (size_t a = 0; a < s.bufs.size(); ++a) out_ptrs[a] = s.bufs[a].data();
  return 0;
}

int dl_release(DLoader* L) {
  if (!L) return -1;
  Slot& s = L->slots[L->next_to_serve % L->depth];
  {
    std::lock_guard<std::mutex> lk(L->mu);
    s.ready.store(false, std::memory_order_release);
    s.seq = -1;
    L->next_to_serve += 1;
  }
  L->cv_free.notify_all();
  return 0;
}

void dl_destroy(DLoader* L) {
  if (!L) return;
  L->stop.store(true, std::memory_order_release);
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->threads) t.join();
  delete L;
}

// Version tag for Python-side compatibility checks. v2: N-array batches
// (dl_create takes array/row-byte vectors, dl_acquire fills N pointers).
int dl_abi_version() { return 3; }

}  // extern "C"
