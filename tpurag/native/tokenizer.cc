// Native tokenizer + term counter for inverted-index builds.
//
// The reference delegates keyword tokenization to the Meilisearch (Rust)
// server; this library is the in-process equivalent for the framework's
// host-side ingest path. Behavior must match tpurag/ingest/tokenizer.py
// exactly (it is the spec; tests cross-check both):
//   - ASCII [a-z0-9_]+ runs, lowercased, are word tokens;
//   - CJK runs (U+3040-30FF, U+3400-4DBF, U+4E00-9FFF, U+AC00-D7AF) emit
//     character bigrams (single char -> unigram);
//   - everything else separates tokens.
//
// Exposed C ABI (consumed via ctypes in tpurag/native/loader.py):
//   char*  tr_term_counts_json(const char* utf8, size_t len);  // JSON obj
//   size_t tr_tokenize_count(const char* utf8, size_t len);
//   void   tr_free(void* p);

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

inline uint64_t fnv1a(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

// String interner: open-addressing table over one contiguous byte arena.
// Replaces unordered_map<string,...> on the ingest hot path — no per-token
// std::string allocation, no per-node heap traffic, one memcmp per probe.
class Interner {
 public:
  Interner() : table_(kInitCap, 0), mask_(kInitCap - 1) {}

  uint32_t intern(const char* s, size_t n, uint64_t h) {
    size_t i = h & mask_;
    while (true) {
      uint32_t v = table_[i];
      if (v == 0) {
        uint32_t idx = size();
        offs_.push_back(static_cast<uint32_t>(buf_.size()));
        lens_.push_back(static_cast<uint32_t>(n));
        hash_.push_back(h);
        buf_.insert(buf_.end(), s, s + n);
        table_[i] = idx + 1;
        if ((size() + 1) * 10 >= (mask_ + 1) * 7) grow();
        return idx;
      }
      uint32_t idx = v - 1;
      if (hash_[idx] == h && lens_[idx] == n &&
          std::memcmp(buf_.data() + offs_[idx], s, n) == 0)
        return idx;
      i = (i + 1) & mask_;
    }
  }

  uint32_t size() const { return static_cast<uint32_t>(offs_.size()); }
  const char* term(uint32_t idx) const { return buf_.data() + offs_[idx]; }
  uint32_t term_len(uint32_t idx) const { return lens_[idx]; }
  size_t arena_payload() const {  // Σ (4 + len) for the packed layout
    return buf_.size() + 4 * offs_.size();
  }

 private:
  static constexpr size_t kInitCap = 4096;

  void grow() {
    size_t cap = (mask_ + 1) * 2;
    std::vector<uint32_t> nt(cap, 0);
    size_t nm = cap - 1;
    for (uint32_t idx = 0; idx < size(); ++idx) {
      size_t i = hash_[idx] & nm;
      while (nt[i]) i = (i + 1) & nm;
      nt[i] = idx + 1;
    }
    table_.swap(nt);
    mask_ = nm;
  }

  std::vector<uint32_t> table_;  // slot -> intern idx + 1 (0 = empty)
  size_t mask_;
  std::vector<char> buf_;
  std::vector<uint32_t> offs_, lens_;
  std::vector<uint64_t> hash_;
};

inline bool is_word_byte(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '_';
}

inline bool is_cjk(uint32_t cp) {
  return (cp >= 0x3040 && cp <= 0x30FF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0xAC00 && cp <= 0xD7AF);
}

// Decode one UTF-8 codepoint; returns bytes consumed (0 on invalid).
inline size_t decode_utf8(const unsigned char* s, size_t len, uint32_t* cp) {
  if (len == 0) return 0;
  unsigned char c = s[0];
  if (c < 0x80) { *cp = c; return 1; }
  if ((c >> 5) == 0x6 && len >= 2 && (s[1] & 0xC0) == 0x80) {
    *cp = ((c & 0x1F) << 6) | (s[1] & 0x3F);
    return 2;
  }
  if ((c >> 4) == 0xE && len >= 3 && (s[1] & 0xC0) == 0x80 &&
      (s[2] & 0xC0) == 0x80) {
    *cp = ((c & 0x0F) << 12) | ((s[1] & 0x3F) << 6) | (s[2] & 0x3F);
    return 3;
  }
  if ((c >> 3) == 0x1E && len >= 4 && (s[1] & 0xC0) == 0x80 &&
      (s[2] & 0xC0) == 0x80 && (s[3] & 0xC0) == 0x80) {
    *cp = ((c & 0x07) << 18) | ((s[1] & 0x3F) << 12) | ((s[2] & 0x3F) << 6) |
          (s[3] & 0x3F);
    return 4;
  }
  *cp = 0xFFFD;
  return 1;
}

inline void encode_utf8(uint32_t cp, std::string* out) {
  if (cp < 0x80) {
    out->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// Emit signature: (const char* token_utf8, size_t len). Tokens live in
// reused buffers — callers must copy (or intern) before the next emit.
template <typename Emit>
void tokenize(const char* data, size_t len, Emit emit) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(data);
  size_t i = 0;
  std::string word;
  std::vector<uint32_t> cjk_run;
  std::string bigram;  // reused scratch for CJK uni/bigrams

  auto flush_word = [&]() {
    if (!word.empty()) {
      emit(word.data(), word.size());
      word.clear();
    }
  };
  auto flush_cjk = [&]() {
    if (cjk_run.size() == 1) {
      bigram.clear();
      encode_utf8(cjk_run[0], &bigram);
      emit(bigram.data(), bigram.size());
    } else if (cjk_run.size() > 1) {
      for (size_t j = 0; j + 1 < cjk_run.size(); ++j) {
        bigram.clear();
        encode_utf8(cjk_run[j], &bigram);
        encode_utf8(cjk_run[j + 1], &bigram);
        emit(bigram.data(), bigram.size());
      }
    }
    cjk_run.clear();
  };

  while (i < len) {
    unsigned char c = s[i];
    if (c < 0x80) {
      unsigned char lc =
          (c >= 'A' && c <= 'Z') ? static_cast<unsigned char>(c + 32) : c;
      if (is_word_byte(lc)) {
        flush_cjk();
        word.push_back(static_cast<char>(lc));
      } else {
        flush_word();
        flush_cjk();
      }
      ++i;
      continue;
    }
    uint32_t cp = 0;
    size_t used = decode_utf8(s + i, len - i, &cp);
    i += used ? used : 1;
    if (is_cjk(cp)) {
      flush_word();
      cjk_run.push_back(cp);
    } else {
      flush_word();
      flush_cjk();
    }
  }
  flush_word();
  flush_cjk();
}

}  // namespace

extern "C" {

char* tr_term_counts_json(const char* data, size_t len) {
  std::unordered_map<std::string, uint32_t> counts;
  tokenize(data, len, [&](const char* t, size_t n) {
    ++counts[std::string(t, n)];
  });
  std::string out = "{";
  bool first = true;
  for (const auto& kv : counts) {
    if (!first) out += ",";
    first = false;
    out += "\"";
    // Terms are [a-z0-9_] or CJK — no JSON metachars — but escape
    // defensively for \ and " anyway.
    for (char ch : kv.first) {
      if (ch == '"' || ch == '\\') out += '\\';
      out += ch;
    }
    out += "\":" + std::to_string(kv.second);
  }
  out += "}";
  char* buf = static_cast<char*>(std::malloc(out.size() + 1));
  std::memcpy(buf, out.c_str(), out.size() + 1);
  return buf;
}

size_t tr_tokenize_count(const char* data, size_t len) {
  size_t n = 0;
  tokenize(data, len, [&](const char*, size_t) { ++n; });
  return n;
}

// Batch tokenize+count: one call per ingest batch instead of one JSON
// round-trip per document (the Rust Meilisearch server the reference
// delegates to also ingests in batches, meilisearch.ts:137).
//
//   buf:  concatenated UTF-8 documents
//   offs: n_docs+1 byte offsets into buf
//
// Returns one malloc'd packed little-endian buffer (tr_free to release):
//   u32 total_bytes               (size of the whole buffer)
//   u32 n_unique                  (batch-unique terms, first-occurrence order)
//   u32 arena_bytes               (4-padded)
//   u32 n_docs
//   u32 total_pairs
//   arena:     n_unique x (u32 len, len bytes)   then pad to 4
//   doc_terms: n_docs u32         (unique terms per doc)
//   pairs:     total_pairs x (u32 uniq_idx, u32 count), doc-major,
//              first-occurrence order within each doc
// The fixed-width tails are 4-aligned so the Python side can view them
// with numpy zero-copy instead of per-pair struct unpacking.
char* tr_batch_term_counts(const char* buf, const uint64_t* offs,
                           uint64_t n_docs) {
  std::unordered_map<std::string, uint32_t> intern;
  std::vector<std::string> arena;
  std::vector<uint32_t> doc_terms(n_docs, 0);
  std::vector<uint32_t> pairs;  // idx, count interleaved

  std::unordered_map<uint32_t, uint32_t> in_doc;  // uniq idx -> pair slot
  for (uint64_t d = 0; d < n_docs; ++d) {
    in_doc.clear();
    const size_t base = pairs.size();
    tokenize(buf + offs[d], static_cast<size_t>(offs[d + 1] - offs[d]),
             [&](const char* tp, size_t tn) {
               std::string t(tp, tn);
               uint32_t idx;
               auto it = intern.find(t);
               if (it == intern.end()) {
                 idx = static_cast<uint32_t>(arena.size());
                 arena.push_back(t);
                 intern.emplace(std::move(t), idx);
               } else {
                 idx = it->second;
               }
               auto jt = in_doc.find(idx);
               if (jt == in_doc.end()) {
                 in_doc.emplace(idx, static_cast<uint32_t>(pairs.size()));
                 pairs.push_back(idx);
                 pairs.push_back(1);
               } else {
                 ++pairs[jt->second + 1];
               }
             });
    doc_terms[d] = static_cast<uint32_t>((pairs.size() - base) / 2);
  }

  size_t arena_bytes = 0;
  for (const auto& t : arena) arena_bytes += 4 + t.size();
  arena_bytes = (arena_bytes + 3) & ~size_t(3);
  const size_t total = 20 + arena_bytes + 4 * n_docs + 4 * pairs.size();
  char* out = static_cast<char*>(std::malloc(total));
  uint32_t* hdr = reinterpret_cast<uint32_t*>(out);
  hdr[0] = static_cast<uint32_t>(total);
  hdr[1] = static_cast<uint32_t>(arena.size());
  hdr[2] = static_cast<uint32_t>(arena_bytes);
  hdr[3] = static_cast<uint32_t>(n_docs);
  hdr[4] = static_cast<uint32_t>(pairs.size() / 2);
  char* p = out + 20;
  for (const auto& t : arena) {
    uint32_t len = static_cast<uint32_t>(t.size());
    std::memcpy(p, &len, 4);
    std::memcpy(p + 4, t.data(), t.size());
    p += 4 + t.size();
  }
  p = out + 20 + arena_bytes;  // skip pad
  std::memcpy(p, doc_terms.data(), 4 * n_docs);
  p += 4 * n_docs;
  if (!pairs.empty()) std::memcpy(p, pairs.data(), 4 * pairs.size());
  return out;
}

// Batch tokenize + count + GROUP BY TERM — the whole host-side restructure
// an inverted-index batch add needs, in one C call (v2 of
// tr_batch_term_counts; that ABI is kept for compatibility). Interning
// uses the open-addressing arena Interner (no per-token allocation), the
// per-doc dedup uses stamp arrays instead of a hash map, and the grouping
// is a counting pass (O(pairs), no sort) — it replaces the Python side's
// stable argsort + diff + per-group repacking (inverted.py add_batch).
//
//   buf:  concatenated UTF-8 documents
//   offs: n_docs+1 byte offsets into buf
//
// Returns one malloc'd packed little-endian buffer (tr_free to release):
//   u32 total_bytes              (size of the whole buffer)
//   u32 n_unique                 (batch-unique terms, first-occurrence order)
//   u32 arena_bytes              (4-padded)
//   u32 n_docs
//   u32 total_pairs
//   arena:      n_unique x (u32 len, len bytes)  then pad to 4
//   doc_total:  n_docs u32       (total token count per doc -> doc_len)
//   gcount:     n_unique u32     (docs containing term u)
//   gdoc:       total_pairs u32  (doc index in batch; grouped by term u
//                                 ascending, doc arrival order within term)
//   gcnt:       total_pairs u32  (term frequency for the same pair)
char* tr_batch_postings(const char* buf, const uint64_t* offs,
                        uint64_t n_docs) {
  Interner intern;
  std::vector<uint32_t> pair_idx, pair_cnt;  // doc-major
  std::vector<uint32_t> doc_pair_start(n_docs + 1, 0);
  std::vector<uint32_t> doc_total(n_docs, 0);
  std::vector<uint32_t> stamp, slot;  // per-doc dedup, sized n_unique

  for (uint64_t d = 0; d < n_docs; ++d) {
    const uint32_t mark = static_cast<uint32_t>(d) + 1;
    tokenize(buf + offs[d], static_cast<size_t>(offs[d + 1] - offs[d]),
             [&](const char* t, size_t n) {
               uint32_t idx = intern.intern(t, n, fnv1a(t, n));
               if (idx >= stamp.size()) {
                 stamp.resize(intern.size(), 0);
                 slot.resize(intern.size(), 0);
               }
               ++doc_total[d];
               if (stamp[idx] != mark) {
                 stamp[idx] = mark;
                 slot[idx] = static_cast<uint32_t>(pair_idx.size());
                 pair_idx.push_back(idx);
                 pair_cnt.push_back(1);
               } else {
                 ++pair_cnt[slot[idx]];
               }
             });
    doc_pair_start[d + 1] = static_cast<uint32_t>(pair_idx.size());
  }

  const uint32_t n_unique = intern.size();
  const size_t total_pairs = pair_idx.size();

  // Counting-group by term idx: offsets, then doc-major placement so each
  // term's postings keep doc arrival order (sequential-add parity).
  std::vector<uint32_t> gcount(n_unique, 0);
  for (uint32_t u : pair_idx) ++gcount[u];
  std::vector<uint32_t> cursor(n_unique + 1, 0);
  for (uint32_t u = 0; u < n_unique; ++u) cursor[u + 1] = cursor[u] + gcount[u];
  std::vector<uint32_t> gdoc(total_pairs), gcnt(total_pairs);
  for (uint64_t d = 0; d < n_docs; ++d) {
    for (uint32_t p = doc_pair_start[d]; p < doc_pair_start[d + 1]; ++p) {
      const uint32_t c = cursor[pair_idx[p]]++;
      gdoc[c] = static_cast<uint32_t>(d);
      gcnt[c] = pair_cnt[p];
    }
  }

  size_t arena_bytes = (intern.arena_payload() + 3) & ~size_t(3);
  const size_t total = 20 + arena_bytes + 4 * n_docs + 4 * n_unique +
                       8 * total_pairs;
  char* out = static_cast<char*>(std::malloc(total));
  uint32_t* hdr = reinterpret_cast<uint32_t*>(out);
  hdr[0] = static_cast<uint32_t>(total);
  hdr[1] = n_unique;
  hdr[2] = static_cast<uint32_t>(arena_bytes);
  hdr[3] = static_cast<uint32_t>(n_docs);
  hdr[4] = static_cast<uint32_t>(total_pairs);
  char* p = out + 20;
  for (uint32_t u = 0; u < n_unique; ++u) {
    const uint32_t len = intern.term_len(u);
    std::memcpy(p, &len, 4);
    std::memcpy(p + 4, intern.term(u), len);
    p += 4 + len;
  }
  p = out + 20 + arena_bytes;  // skip pad
  std::memcpy(p, doc_total.data(), 4 * n_docs);
  p += 4 * n_docs;
  if (n_unique) std::memcpy(p, gcount.data(), 4 * n_unique);
  p += 4 * n_unique;
  if (total_pairs) {
    std::memcpy(p, gdoc.data(), 4 * total_pairs);
    std::memcpy(p + 4 * total_pairs, gcnt.data(), 4 * total_pairs);
  }
  return out;
}

void tr_free(void* p) { std::free(p); }

}  // extern "C"
