// Native fast path for the hashing tokenizer (models/tokenizer.py
// SimpleTokenizer): BERT-style basic tokenization (lowercase, whitespace
// split, punctuation isolation) + md5-based stable ids, byte-identical to
// the Python implementation for ASCII text. Texts containing any
// non-ASCII byte are flagged so the caller falls back to Python for that
// text (Python's tokenizer consults full Unicode category tables there).
//
// The per-character Python path is the slow part of tokenizing a rerank
// wave; this does the same work natively.
//
// md5: self-contained RFC 1321 implementation (public-domain style); only
// digest bytes 0..3 (little-endian word A) are consumed, matching
// int.from_bytes(md5(tok).digest()[:4], "little").

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// md5
// ---------------------------------------------------------------------------

struct MD5 {
  uint32_t a0 = 0x67452301, b0 = 0xefcdab89, c0 = 0x98badcfe, d0 = 0x10325476;

  static uint32_t rotl(uint32_t x, uint32_t c) {
    return (x << c) | (x >> (32 - c));
  }

  void block(const uint8_t* p) {
    static const uint32_t K[64] = {
        0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf,
        0x4787c62a, 0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af,
        0xffff5bb1, 0x895cd7be, 0x6b901122, 0xfd987193, 0xa679438e,
        0x49b40821, 0xf61e2562, 0xc040b340, 0x265e5a51, 0xe9b6c7aa,
        0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8, 0x21e1cde6,
        0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
        0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122,
        0xfde5380c, 0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70,
        0x289b7ec6, 0xeaa127fa, 0xd4ef3085, 0x04881d05, 0xd9d4d039,
        0xe6db99e5, 0x1fa27cf8, 0xc4ac5665, 0xf4292244, 0x432aff97,
        0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92, 0xffeff47d,
        0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
        0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};
    static const uint32_t S[64] = {
        7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
        5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20,
        4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
        6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21};
    uint32_t M[16];
    for (int i = 0; i < 16; i++) {
      M[i] = (uint32_t)p[4 * i] | ((uint32_t)p[4 * i + 1] << 8) |
             ((uint32_t)p[4 * i + 2] << 16) | ((uint32_t)p[4 * i + 3] << 24);
    }
    uint32_t A = a0, B = b0, C = c0, D = d0;
    for (int i = 0; i < 64; i++) {
      uint32_t F;
      int g;
      if (i < 16) {
        F = (B & C) | (~B & D);
        g = i;
      } else if (i < 32) {
        F = (D & B) | (~D & C);
        g = (5 * i + 1) & 15;
      } else if (i < 48) {
        F = B ^ C ^ D;
        g = (3 * i + 5) & 15;
      } else {
        F = C ^ (B | ~D);
        g = (7 * i) & 15;
      }
      F = F + A + K[i] + M[g];
      A = D;
      D = C;
      C = B;
      B = B + rotl(F, S[i]);
    }
    a0 += A;
    b0 += B;
    c0 += C;
    d0 += D;
  }

  // first 32 bits of the digest (little-endian word A), for short inputs
  uint32_t digest32(const uint8_t* data, size_t len) {
    size_t full = len / 64;
    for (size_t i = 0; i < full; i++) block(data + 64 * i);
    uint8_t tail[128] = {0};
    size_t rem = len - full * 64;
    memcpy(tail, data + full * 64, rem);
    tail[rem] = 0x80;
    size_t tlen = (rem + 9 <= 64) ? 64 : 128;
    uint64_t bits = (uint64_t)len * 8;
    for (int i = 0; i < 8; i++) tail[tlen - 8 + i] = (bits >> (8 * i)) & 0xff;
    block(tail);
    if (tlen == 128) block(tail + 64);
    return a0;
  }
};

inline bool is_space(uint8_t c) {
  // Python str.isspace for ASCII: \t-\r, \x1c-\x1f, ' '
  return (c >= 0x09 && c <= 0x0d) || (c >= 0x1c && c <= 0x1f) || c == 0x20;
}

inline bool is_punct(uint8_t c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

inline int32_t tok_id(const uint8_t* p, size_t n, int32_t vocab_size,
                      int32_t n_special) {
  MD5 m;
  uint32_t h = m.digest32(p, n);
  return n_special + (int32_t)(h % (uint32_t)(vocab_size - n_special));
}

}  // namespace

extern "C" {

// Tokenize one text into hash ids. Returns the number of ids written, or
// -1 if the text contains a non-ASCII byte (caller must use the Python
// path for exact Unicode semantics). out must hold at least len entries
// (one token per char is the worst case).
int64_t simpletok_encode(const char* text, int64_t len, int32_t vocab_size,
                         int32_t n_special, int32_t* out) {
  const uint8_t* s = (const uint8_t*)text;
  std::vector<uint8_t> buf;
  buf.reserve(64);
  int64_t n_out = 0;
  auto flush = [&]() {
    if (!buf.empty()) {
      out[n_out++] = tok_id(buf.data(), buf.size(), vocab_size, n_special);
      buf.clear();
    }
  };
  for (int64_t i = 0; i < len; i++) {
    uint8_t c = s[i];
    if (c >= 0x80) return -1;  // non-ASCII → Python fallback
    if (c >= 'A' && c <= 'Z') c += 32;  // lowercase
    if (is_space(c)) {
      flush();
    } else if (is_punct(c)) {
      flush();
      out[n_out++] = tok_id(&c, 1, vocab_size, n_special);
    } else {
      buf.push_back(c);
    }
  }
  flush();
  return n_out;
}

}  // extern "C"
