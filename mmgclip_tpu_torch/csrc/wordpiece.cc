// Batch WordPiece encoder for ASCII text (the port's copy of the JAX
// package's native/wordpiece.cc, built by mmgclip_tpu_torch/ops/_build.py
// with the host C++ compiler into mmgclip_tpu_torch/_build/).
//
// It implements the ASCII subset of HuggingFace BertTokenizer semantics
// exactly: for pure-ASCII text, HF's BasicTokenizer reduces to: drop control
// chars (\t\n\r become spaces), whitespace-split, ASCII-lowercase (NFD
// accent stripping is the identity), and split out the four ASCII
// punctuation blocks (33-47, 58-64, 91-96, 123-126).  Non-ASCII strings never
// reach this code: mmgclip_tpu_torch/data/native_wordpiece.py routes them to
// the pure-Python tokenizer, and tests/test_torch_native_wordpiece.py pins
// id-equality of the paths.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> ids;
  int32_t pad_id = 0, unk_id = 1, cls_id = 2, sep_id = 3;
};

inline bool is_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) || (c >= 91 && c <= 96) ||
         (c >= 123 && c <= 126);
}

// Greedy longest-match-first WordPiece; whole-word UNK when any piece fails.
void wordpiece(const Vocab& v, const std::string& word, int max_chars,
               std::vector<int32_t>* out) {
  if (static_cast<int>(word.size()) > max_chars) {
    out->push_back(v.unk_id);
    return;
  }
  std::vector<int32_t> pieces;
  size_t start = 0;
  std::string probe;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t piece_id = -1;
    while (end > start) {
      probe.assign(start > 0 ? "##" : "");
      probe.append(word, start, end - start);
      auto it = v.ids.find(probe);
      if (it != v.ids.end()) {
        piece_id = it->second;
        break;
      }
      --end;
    }
    if (piece_id < 0) {
      out->push_back(v.unk_id);
      return;
    }
    pieces.push_back(piece_id);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

// vocab_blob: '\n'-separated tokens, id = line index (the vocab.txt format).
void* wp_create(const char* vocab_blob) {
  auto* v = new Vocab();
  const char* p = vocab_blob;
  int32_t id = 0;
  while (*p) {
    const char* nl = strchr(p, '\n');
    size_t len = nl ? static_cast<size_t>(nl - p) : strlen(p);
    if (len > 0) {
      v->ids.emplace(std::string(p, len), id);
    }
    // id = LINE index unconditionally: an empty line must still consume its
    // id, or every later token would shift off-by-one vs the Python vocab
    ++id;
    if (!nl) break;
    p = nl + 1;
  }
  auto special = [&](const char* tok, int32_t fallback) {
    auto it = v->ids.find(tok);
    return it != v->ids.end() ? it->second : fallback;
  };
  v->pad_id = special("[PAD]", 0);
  v->unk_id = special("[UNK]", 1);
  v->cls_id = special("[CLS]", 2);
  v->sep_id = special("[SEP]", 3);
  return v;
}

void wp_free(void* handle) { delete static_cast<Vocab*>(handle); }

// texts_blob + offsets[n+1]: text i is bytes [offsets[i], offsets[i+1]).
// Emits [n, max_len] int32 ids (padded, truncated with [SEP] kept last) and
// the attention mask.  Returns 0 on success, -1 on non-ASCII input (the
// caller must route those through the Python tokenizer).
int wp_encode_batch(void* handle, const char* texts_blob, const int64_t* offsets,
                    int n, int max_len, int lowercase, int max_chars,
                    int32_t* out_ids, int32_t* out_mask) {
  // [CLS] + [SEP] is the minimum frame; max_len < 2 would underflow the
  // truncation's resize(max_len - 1) to SIZE_MAX and std::terminate the
  // whole process through the C ABI
  if (max_len < 2) return -2;
  const Vocab& v = *static_cast<Vocab*>(handle);
  std::vector<int32_t> ids;
  std::string word;
  for (int i = 0; i < n; ++i) {
    ids.clear();
    ids.push_back(v.cls_id);
    word.clear();
    auto flush_word = [&]() {
      if (!word.empty()) {
        wordpiece(v, word, max_chars, &ids);
        word.clear();
      }
    };
    for (int64_t pos = offsets[i]; pos < offsets[i + 1]; ++pos) {
      unsigned char c = static_cast<unsigned char>(texts_blob[pos]);
      if (c >= 0x80) return -1;  // non-ASCII: Python path required
      if (c == '\t' || c == '\n' || c == '\r') c = ' ';
      if (c < 0x20 || c == 0x7f) continue;  // control chars drop
      if (c == ' ') {
        flush_word();
        continue;
      }
      if (lowercase && c >= 'A' && c <= 'Z') c = static_cast<unsigned char>(c + 32);
      if (is_punct(c)) {
        flush_word();  // punctuation chars are standalone words
        word.assign(1, static_cast<char>(c));
        flush_word();
        continue;
      }
      word.push_back(static_cast<char>(c));
    }
    flush_word();
    ids.push_back(v.sep_id);
    // HF truncation: inner tokens cut so [SEP] stays last
    if (static_cast<int>(ids.size()) > max_len) {
      ids.resize(max_len - 1);
      ids.push_back(v.sep_id);
    }
    int32_t* row_ids = out_ids + static_cast<int64_t>(i) * max_len;
    int32_t* row_mask = out_mask + static_cast<int64_t>(i) * max_len;
    for (int j = 0; j < max_len; ++j) {
      bool valid = j < static_cast<int>(ids.size());
      row_ids[j] = valid ? ids[j] : v.pad_id;
      row_mask[j] = valid ? 1 : 0;
    }
  }
  return 0;
}

}  // extern "C"
