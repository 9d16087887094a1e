// Native token-shard reader: mmap'd pre-tokenized shards + a background
// prefetch thread keeping a bounded queue of ready batches.
//
// Role-parity with the reference's native input pipeline (its BERT/Llama
// examples read pre-tokenized HDF5 shards through libhdf5(C) worker
// processes, examples/training/tp_dp_bert_large_hf_pretrain_hdf5.py): the
// host-side data path must not steal step time from the accelerator loop.
// Exposed as a plain C API consumed via ctypes (no pybind11 in this image).
//
// Shard format (little-endian):
//   u64 magic = 0x4e58445348415244 ("NXDSHARD")
//   u64 seq_len
//   u64 num_seqs
//   i32 tokens[num_seqs * seq_len]

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <random>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x4e58445348415244ULL;

struct Shard {
  const int32_t* tokens = nullptr;  // mmap'd payload
  uint64_t num_seqs = 0;
  void* map = nullptr;
  size_t map_len = 0;
};

struct Reader {
  std::vector<Shard> shards;
  uint64_t seq_len = 0;
  uint64_t batch = 0;
  uint64_t total_seqs = 0;
  std::vector<uint64_t> order;      // global sequence permutation
  uint64_t cursor = 0;              // next per-rank position (epoch wraps)
  uint64_t seed = 0;
  uint64_t epoch = 0;
  // process sharding (DistributedSampler role): rank r reads positions
  // r, r+world, r+2*world, ... of the epoch permutation; the remainder
  // (total % world) is dropped so every rank sees the same count per epoch.
  uint64_t rank = 0;
  uint64_t world = 1;
  uint64_t per_rank = 0;

  // prefetch machinery
  std::deque<std::vector<int32_t>> queue;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::thread worker;
  std::atomic<bool> stop{false};
  size_t max_queue = 4;

  const int32_t* seq_ptr(uint64_t global_idx) const {
    for (const Shard& s : shards) {
      if (global_idx < s.num_seqs) return s.tokens + global_idx * seq_len;
      global_idx -= s.num_seqs;
    }
    return nullptr;
  }

  void reshuffle() {
    order.resize(total_seqs);
    for (uint64_t i = 0; i < total_seqs; ++i) order[i] = i;
    if (seed != 0) {
      std::mt19937_64 rng(seed + epoch);
      for (uint64_t i = total_seqs; i > 1; --i) {
        uint64_t j = rng() % i;
        std::swap(order[i - 1], order[j]);
      }
    }
  }

  void fill_batch(std::vector<int32_t>& out) {
    out.resize(batch * seq_len);
    for (uint64_t b = 0; b < batch; ++b) {
      if (cursor >= per_rank) {  // epoch boundary: reshuffle + wrap
        cursor = 0;
        ++epoch;
        reshuffle();
      }
      const int32_t* src = seq_ptr(order[cursor * world + rank]);
      ++cursor;
      std::memcpy(out.data() + b * seq_len, src, seq_len * sizeof(int32_t));
    }
  }

  void run() {
    while (!stop.load()) {
      std::vector<int32_t> buf;
      fill_batch(buf);
      std::unique_lock<std::mutex> lk(mu);
      cv_put.wait(lk, [&] { return queue.size() < max_queue || stop.load(); });
      if (stop.load()) return;
      queue.emplace_back(std::move(buf));
      cv_get.notify_one();
    }
  }
};

bool map_shard(const char* path, uint64_t expect_seq_len, Shard* out) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return false; }
  void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (m == MAP_FAILED) return false;
  const uint64_t* hdr = static_cast<const uint64_t*>(m);
  if (st.st_size < 24 || hdr[0] != kMagic || hdr[1] != expect_seq_len) {
    munmap(m, st.st_size);
    return false;
  }
  uint64_t num_seqs = hdr[2];
  // divide, don't multiply: `num_seqs * seq_len * 4` overflows uint64 for a
  // corrupt header and would bypass the size check into OOB reads
  uint64_t payload = static_cast<uint64_t>(st.st_size) - 24;
  // cap seq_len so the divisor can neither overflow nor reach zero
  if (expect_seq_len == 0 || expect_seq_len > (1ULL << 32) ||
      num_seqs > payload / (expect_seq_len * sizeof(int32_t))) {
    munmap(m, st.st_size);
    return false;
  }
  out->map = m;
  out->map_len = st.st_size;
  out->num_seqs = num_seqs;
  out->tokens = reinterpret_cast<const int32_t*>(static_cast<const char*>(m) + 24);
  return true;
}

}  // namespace

extern "C" {

// Returns an opaque handle (heap Reader*), or nullptr on failure.
// rank/world shard the epoch permutation across processes (world=1: no
// sharding); requires rank < world and total_seqs >= world.
// start_epoch/start_cursor resume the stream at an exact position (O(1) —
// the epoch permutation is a pure function of seed+epoch, so seeking is one
// reshuffle, not a replay): the checkpoint-resume path of the training loop.
void* tsr_open(const char** paths, int n_paths, uint64_t seq_len,
               uint64_t batch, uint64_t shuffle_seed,
               uint64_t rank, uint64_t world,
               uint64_t start_epoch, uint64_t start_cursor) {
  if (world == 0 || rank >= world) return nullptr;
  auto* r = new Reader();
  r->seq_len = seq_len;
  r->batch = batch;
  r->seed = shuffle_seed;
  r->rank = rank;
  r->world = world;
  for (int i = 0; i < n_paths; ++i) {
    Shard s;
    if (!map_shard(paths[i], seq_len, &s)) {
      for (Shard& sh : r->shards) munmap(sh.map, sh.map_len);
      delete r;
      return nullptr;
    }
    r->total_seqs += s.num_seqs;
    r->shards.push_back(s);
  }
  r->per_rank = r->total_seqs / r->world;
  if (r->per_rank == 0) {
    for (Shard& sh : r->shards) munmap(sh.map, sh.map_len);
    delete r;
    return nullptr;
  }
  r->epoch = start_epoch;
  r->cursor = start_cursor;  // >= per_rank wraps in fill_batch's epoch check
  r->reshuffle();
  r->worker = std::thread([r] { r->run(); });
  return r;
}

// Copies the next batch (batch*seq_len int32) into out. Returns 0 on success.
int tsr_next(void* handle, int32_t* out) {
  auto* r = static_cast<Reader*>(handle);
  std::vector<int32_t> buf;
  {
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_get.wait(lk, [&] { return !r->queue.empty() || r->stop.load(); });
    if (r->queue.empty()) return 1;
    buf = std::move(r->queue.front());
    r->queue.pop_front();
    r->cv_put.notify_one();
  }
  std::memcpy(out, buf.data(), buf.size() * sizeof(int32_t));
  return 0;
}

uint64_t tsr_total_seqs(void* handle) {
  return static_cast<Reader*>(handle)->total_seqs;
}

void tsr_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  r->stop.store(true);
  r->cv_put.notify_all();
  r->cv_get.notify_all();
  if (r->worker.joinable()) r->worker.join();
  for (Shard& s : r->shards) munmap(s.map, s.map_len);
  delete r;
}

}  // extern "C"
