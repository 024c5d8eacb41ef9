// stair_tpu_torch native runtime: the host-side hot memory paths.
//
// The reference relies on native code for its data path (h5py's C HDF5
// reader, decord's C++ video decoder, torch DataLoader workers). This
// library is the equivalent for the input pipeline: video features
// live in one contiguous arena, and batch assembly — the per-batch gather of
// ragged per-video features into padded [B, F, D] device buffers plus mask
// fill — runs here multithreaded, off the Python interpreter. Gold-attention
// rasterization (span_to_attention over many supervision targets) is also
// provided.
//
// Exposed via a plain C ABI consumed with ctypes (no pybind11 dependency).
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread native.cpp -o _native.so

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) across up to `threads` workers.
template <typename F>
void parallel_for(int64_t n, int threads, F fn) {
  if (n <= 0) return;
  int workers = std::min<int64_t>(threads, n);
  if (workers <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([&] {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& t : pool) t.join();
}

// Word vocabulary for host-side question tokenization. Mirrors the Python
// EmbeddingArena's first-seen id assignment: Python seeds it with the
// arena's word list (stair_vocab_add_words) and, after a tokenize call
// that grew it, reads back the new words to compute their embedding rows.
struct Vocab {
  std::mutex mu;
  std::unordered_map<std::string, int32_t> word2id;
  std::vector<std::string> words;
};
Vocab g_vocab;

}  // namespace

extern "C" {

// Gather ragged per-example rows from a contiguous arena into a padded
// [B, F, D] batch plus a [B, F] validity mask. `offsets[b]` is the row
// offset of example b's features in the arena; `lengths[b]` its row count
// (clamped to F).
void stair_gather_pad_f32(const float* arena, const int64_t* offsets,
                          const int32_t* lengths, int64_t batch, int64_t max_rows,
                          int64_t dim, float* out, float* mask, int threads) {
  parallel_for(batch, threads, [&](int64_t b) {
    const int64_t rows = std::min<int64_t>(lengths[b], max_rows);
    const float* src = arena + offsets[b] * dim;
    float* dst = out + b * max_rows * dim;
    std::memcpy(dst, src, sizeof(float) * rows * dim);
    std::memset(dst + rows * dim, 0, sizeof(float) * (max_rows - rows) * dim);
    float* m = mask + b * max_rows;
    std::fill(m, m + rows, 1.0f);
    std::fill(m + rows, m + max_rows, 0.0f);
  });
}

// Rasterize fractional frame intervals into per-frame weights, matching the
// reference span_to_attention semantics (train_module.py:67-81): interior
// frames get 1, boundary frames the fractional overlap.
// intervals: [N, 2] (start, end) floats; out: [N, F].
void stair_span_to_attention(const float* intervals, int64_t n, int64_t frames,
                             float* out, int threads) {
  parallel_for(n, threads, [&](int64_t i) {
    float* row = out + i * frames;
    std::memset(row, 0, sizeof(float) * frames);
    const double fmax = static_cast<double>(frames);
    double start = std::min(fmax - 0.002, std::max(0.001, (double)intervals[2 * i]));
    double end = std::min(fmax - 0.001, (double)intervals[2 * i + 1]);
    int64_t s = (int64_t)std::ceil(start);
    int64_t e = (int64_t)std::floor(end);
    if (s < e) {
      for (int64_t f = s; f < e; ++f) row[f] += 1.0f;
    }
    if (s <= e) {
      if (s - 1 >= 0 && s - 1 < frames) row[s - 1] += (float)(s - start);
      if (e >= 0 && e < frames) row[e] += (float)(end - e);
    } else if (e >= 0 && e < frames) {
      row[e] += (float)(end - start);
    }
  });
}

// Embedding-row gather: out[i] = table[ids[i]] (ids < 0 leave zeros).
void stair_gather_rows_f32(const float* table, const int64_t* ids, int64_t n,
                           int64_t dim, float* out, int threads) {
  parallel_for(n, threads, [&](int64_t i) {
    if (ids[i] < 0) {
      std::memset(out + i * dim, 0, sizeof(float) * dim);
    } else {
      std::memcpy(out + i * dim, table + ids[i] * dim, sizeof(float) * dim);
    }
  });
}

// ---- question tokenization (str.lower().split() -> vocab ids) --------------

// Reset the vocabulary (e.g. before re-seeding from a fresh arena).
void stair_vocab_reset() {
  std::lock_guard<std::mutex> lock(g_vocab.mu);
  g_vocab.word2id.clear();
  g_vocab.words.clear();
}

// Append words (concatenated, NUL-separated) in order; ids are assigned
// first-seen, matching EmbeddingArena._id. Returns the vocabulary size.
int64_t stair_vocab_add_words(const char* blob, const int64_t* offsets,
                              int64_t n) {
  std::lock_guard<std::mutex> lock(g_vocab.mu);
  for (int64_t i = 0; i < n; ++i) {
    std::string w(blob + offsets[i]);
    if (g_vocab.word2id.emplace(w, (int32_t)g_vocab.words.size()).second)
      g_vocab.words.push_back(std::move(w));
  }
  return (int64_t)g_vocab.words.size();
}

int64_t stair_vocab_size() {
  std::lock_guard<std::mutex> lock(g_vocab.mu);
  return (int64_t)g_vocab.words.size();
}

// Copy word `i` into buf (NUL-terminated); returns its length or -1.
int64_t stair_vocab_word(int64_t i, char* buf, int64_t cap) {
  std::lock_guard<std::mutex> lock(g_vocab.mu);
  if (i < 0 || i >= (int64_t)g_vocab.words.size()) return -1;
  const std::string& w = g_vocab.words[i];
  if ((int64_t)w.size() + 1 > cap) return -1;
  std::memcpy(buf, w.c_str(), w.size() + 1);
  return (int64_t)w.size();
}

// Tokenize a batch of sentences to vocabulary ids:
// ``sentence.lower().split()[:max_len]`` semantics (ASCII lowercase — the
// AGQA question corpus is ASCII). ids_out [batch, max_len] int32, -1 = pad.
// With grow != 0, unseen words are appended to the vocabulary (the caller
// then syncs new embedding rows); otherwise they map to -1.
void stair_tokenize_ids(const char* blob, const int64_t* offsets,
                        int64_t batch, int32_t max_len, int32_t* ids_out,
                        int32_t grow) {
  std::lock_guard<std::mutex> lock(g_vocab.mu);
  std::string word;
  for (int64_t b = 0; b < batch; ++b) {
    const char* s = blob + offsets[b];
    int32_t* row = ids_out + b * max_len;
    std::fill(row, row + max_len, -1);
    int32_t k = 0;
    for (const char* p = s; *p != '\0' && k < max_len;) {
      while (*p != '\0' && std::isspace((unsigned char)*p)) ++p;
      if (*p == '\0') break;
      word.clear();
      while (*p != '\0' && !std::isspace((unsigned char)*p)) {
        word.push_back((char)std::tolower((unsigned char)*p));
        ++p;
      }
      auto it = g_vocab.word2id.find(word);
      if (it != g_vocab.word2id.end()) {
        row[k++] = it->second;
      } else if (grow) {
        int32_t id = (int32_t)g_vocab.words.size();
        g_vocab.word2id.emplace(word, id);
        g_vocab.words.push_back(word);
        row[k++] = id;
      } else {
        row[k++] = -1;
      }
    }
  }
}

int stair_native_version() { return 2; }

}  // extern "C"
