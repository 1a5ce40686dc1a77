// Native text analyzer + postings builder for the BM25 index.
//
// The reference delegates sparse indexing to native engines (ParadeDB's
// Rust/Tantivy BM25 — SURVEY.md §2.3); this is the framework's own native
// host-side piece: tokenization (lowercase ASCII alnum runs, matching the
// Python analyzer in retrieval/sparse.py), vocabulary interning, and
// per-document term-frequency counting, emitting the (term, row, tf)
// triplets the device index flushes from. Exposed through a C ABI for
// ctypes (no pybind11 in this environment).
//
// Build: make -C ragmeup_tpu_torch/native LIB=<path>/libraganalyzer.so

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Analyzer {
  std::unordered_map<std::string, int32_t> vocab;
  std::vector<std::string> terms;           // id → term
  std::vector<int32_t> tids, rows;
  std::vector<float> tfs;
  std::vector<int32_t> doc_lens;

  int32_t intern(std::string_view term) {
    auto it = vocab.find(std::string(term));
    if (it != vocab.end()) return it->second;
    int32_t id = static_cast<int32_t>(terms.size());
    terms.emplace_back(term);
    vocab.emplace(terms.back(), id);
    return id;
  }
};

inline bool is_alnum_lower(unsigned char c, char &out) {
  if (c >= 'a' && c <= 'z') { out = static_cast<char>(c); return true; }
  if (c >= 'A' && c <= 'Z') { out = static_cast<char>(c - 'A' + 'a'); return true; }
  if (c >= '0' && c <= '9') { out = static_cast<char>(c); return true; }
  return false;
}

}  // namespace

extern "C" {

void *analyzer_create() { return new Analyzer(); }

void analyzer_destroy(void *h) { delete static_cast<Analyzer *>(h); }

// Tokenize+count docs [row_start, row_start+n_docs). `buf` holds the
// concatenated UTF-8 texts; doc i spans [offsets[i], offsets[i+1]).
// Returns the total number of postings accumulated so far.
int64_t analyzer_add_batch(void *h, const char *buf, const int64_t *offsets,
                           int64_t n_docs, int32_t row_start) {
  auto *a = static_cast<Analyzer *>(h);
  std::string tok;
  // per-doc counting with a small local map
  std::unordered_map<int32_t, int32_t> counts;
  for (int64_t i = 0; i < n_docs; ++i) {
    counts.clear();
    int32_t len = 0;
    const char *p = buf + offsets[i];
    const char *end = buf + offsets[i + 1];
    tok.clear();
    auto flush = [&]() {
      if (!tok.empty()) {
        ++counts[a->intern(tok)];
        ++len;
        tok.clear();
      }
    };
    for (; p != end; ++p) {
      char c;
      if (is_alnum_lower(static_cast<unsigned char>(*p), c)) tok.push_back(c);
      else flush();
    }
    flush();
    a->doc_lens.push_back(len);
    int32_t row = row_start + static_cast<int32_t>(i);
    for (const auto &kv : counts) {
      a->tids.push_back(kv.first);
      a->rows.push_back(row);
      a->tfs.push_back(static_cast<float>(kv.second));
    }
  }
  return static_cast<int64_t>(a->tids.size());
}

int64_t analyzer_num_postings(void *h) {
  return static_cast<int64_t>(static_cast<Analyzer *>(h)->tids.size());
}

void analyzer_postings(void *h, int32_t *tids, int32_t *rows, float *tfs) {
  auto *a = static_cast<Analyzer *>(h);
  std::memcpy(tids, a->tids.data(), a->tids.size() * sizeof(int32_t));
  std::memcpy(rows, a->rows.data(), a->rows.size() * sizeof(int32_t));
  std::memcpy(tfs, a->tfs.data(), a->tfs.size() * sizeof(float));
}

void analyzer_clear_postings(void *h) {
  auto *a = static_cast<Analyzer *>(h);
  a->tids.clear();
  a->rows.clear();
  a->tfs.clear();
  a->doc_lens.clear();
}

int64_t analyzer_vocab_size(void *h) {
  return static_cast<int64_t>(static_cast<Analyzer *>(h)->terms.size());
}

int64_t analyzer_vocab_bytes(void *h) {
  auto *a = static_cast<Analyzer *>(h);
  int64_t total = 0;
  for (const auto &t : a->terms) total += static_cast<int64_t>(t.size()) + 1;
  return total;
}

// '\n'-joined terms in id order (caller allocates analyzer_vocab_bytes).
void analyzer_vocab(void *h, char *out) {
  auto *a = static_cast<Analyzer *>(h);
  for (const auto &t : a->terms) {
    std::memcpy(out, t.data(), t.size());
    out += t.size();
    *out++ = '\n';
  }
}

int64_t analyzer_num_docs(void *h) {
  return static_cast<int64_t>(static_cast<Analyzer *>(h)->doc_lens.size());
}

void analyzer_doc_lens(void *h, int32_t *out) {
  auto *a = static_cast<Analyzer *>(h);
  std::memcpy(out, a->doc_lens.data(), a->doc_lens.size() * sizeof(int32_t));
}

// Preload an existing vocabulary ('\n'-joined) so term ids stay stable
// across save/load.
void analyzer_load_vocab(void *h, const char *buf, int64_t nbytes) {
  auto *a = static_cast<Analyzer *>(h);
  const char *p = buf, *end = buf + nbytes;
  while (p < end) {
    const char *nl = static_cast<const char *>(std::memchr(p, '\n', end - p));
    if (!nl) nl = end;
    a->intern(std::string_view(p, nl - p));
    p = nl + 1;
  }
}

}  // extern "C"
