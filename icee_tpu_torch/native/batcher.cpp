// Native host data-path: threaded padded-batch assembly + token histogram.
//
// The reference's only host parallelism is torch DataLoader worker processes
// re-tokenizing text per epoch (SURVEY.md §2.5).  Here captions are encoded
// once into a flat ragged int32 store, and per-batch work reduces to
// memcpy-with-padding — done in C++ threads so the Python feeder thread never
// stalls the device's step loop.
//
// Exposed C ABI (ctypes, see icee_tpu_torch/native/__init__.py):
//   make_padded_batch : gather ragged rows by index -> (n, max_len) padded
//                       matrix + lengths, truncating at max_len
//   count_tokens      : vocabulary-sized token histogram (unigram stats for
//                       the SentiCap log-unigram output bias, vocab pruning)
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread batcher.cpp
//        (driven by icee_tpu_torch/native/__init__.py::build_library)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// data: flat token stream; offsets: n_seqs+1 prefix offsets into data.
// indices: rows to gather; out_captions: (n, max_len) pre-filled or not —
// fully overwritten here; out_lengths: (n,).
void make_padded_batch(const int32_t* data, const int64_t* offsets,
                       const int64_t* indices, int64_t n, int32_t max_len,
                       int32_t pad_id, int32_t* out_captions,
                       int32_t* out_lengths, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      const int64_t row = indices[i];
      const int64_t start = offsets[row];
      const int64_t stop = offsets[row + 1];
      int32_t len = static_cast<int32_t>(
          std::min<int64_t>(stop - start, max_len));
      int32_t* out = out_captions + i * max_len;
      std::memcpy(out, data + start, sizeof(int32_t) * len);
      for (int32_t j = len; j < max_len; ++j) out[j] = pad_id;
      out_lengths[i] = len;
    }
  };
  if (n_threads == 1 || n < 2 * n_threads) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t b = t * chunk;
    const int64_t e = std::min<int64_t>(b + chunk, n);
    if (b >= e) break;
    threads.emplace_back(worker, b, e);
  }
  for (auto& th : threads) th.join();
}

void count_tokens(const int32_t* data, int64_t n_tokens, int32_t vocab_size,
                  int64_t* counts, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::memset(counts, 0, sizeof(int64_t) * vocab_size);
  if (n_threads == 1 || n_tokens < 1 << 16) {
    for (int64_t i = 0; i < n_tokens; ++i) {
      const int32_t t = data[i];
      if (t >= 0 && t < vocab_size) ++counts[t];
    }
    return;
  }
  std::vector<std::vector<int64_t>> partial(
      n_threads, std::vector<int64_t>(vocab_size, 0));
  std::vector<std::thread> threads;
  const int64_t chunk = (n_tokens + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t b = t * chunk;
    const int64_t e = std::min<int64_t>(b + chunk, n_tokens);
    if (b >= e) break;
    threads.emplace_back([&, t, b, e]() {
      auto& local = partial[t];
      for (int64_t i = b; i < e; ++i) {
        const int32_t tok = data[i];
        if (tok >= 0 && tok < vocab_size) ++local[tok];
      }
    });
  }
  for (auto& th : threads) th.join();
  for (const auto& local : partial)
    for (int32_t v = 0; v < vocab_size; ++v) counts[v] += local[v];
}

}  // extern "C"
