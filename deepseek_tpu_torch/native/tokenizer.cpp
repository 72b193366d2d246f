// Native greedy longest-prefix-match tokenizer: the port's copy of
// deepseek_tpu/native/tokenizer.cpp.
//
// Same behavior as the Python Tokenizer in tokenizer.py
// (reference analogue: the C++ trie tokenizer, tokenizer.cpp:57-94): the
// vocab is a NUL-separated byte blob; encode walks a byte trie taking the
// longest matching vocab entry, falling back to the 256 byte tokens when no
// prefix matches.
//
// Built by native/build.py at first use (g++ -O3 -std=c++17 -shared -fPIC
// -fopenmp -march=native).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Trie {
  // edge-compressed: per node a sorted vector of (byte, child) pairs
  struct Node {
    int32_t token_id = -1;
    std::vector<std::pair<uint8_t, int32_t>> edges;
    int32_t find(uint8_t b) const {
      // vocab fan-out is small except at the root; linear scan is fine
      for (auto& e : edges)
        if (e.first == b) return e.second;
      return -1;
    }
  };
  std::vector<Node> nodes;
  int32_t root_children[256];

  Trie() {
    nodes.emplace_back();
    std::memset(root_children, 0xff, sizeof(root_children));
  }

  void insert(const uint8_t* word, int64_t len, int32_t token_id) {
    if (len == 0) return;
    int32_t cur = root_children[word[0]];
    if (cur < 0) {
      cur = (int32_t)nodes.size();
      nodes.emplace_back();
      root_children[word[0]] = cur;
    }
    for (int64_t i = 1; i < len; i++) {
      int32_t nxt = nodes[cur].find(word[i]);
      if (nxt < 0) {
        nxt = (int32_t)nodes.size();
        nodes.emplace_back();
        nodes[cur].edges.emplace_back(word[i], nxt);
      }
      cur = nxt;
    }
    nodes[cur].token_id = token_id;
  }
};

}  // namespace

extern "C" {

void* dseek_tokenizer_create(const uint8_t* blob, int64_t blob_len) {
  auto* t = new Trie();
  int32_t token_id = 0;
  int64_t start = 0;
  for (int64_t i = 0; i < blob_len; i++) {
    if (blob[i] == 0) {
      t->insert(blob + start, i - start, token_id++);
      start = i + 1;
    }
  }
  if (start < blob_len) t->insert(blob + start, blob_len - start, token_id++);
  return t;
}

void dseek_tokenizer_destroy(void* handle) { delete (Trie*)handle; }

// Returns number of tokens written (<= out_cap). byte_fallback_start < 0
// means no byte fallback (unknown bytes are skipped, like the reference).
int64_t dseek_tokenizer_encode(void* handle, const uint8_t* text, int64_t len,
                               int32_t* out, int64_t out_cap,
                               int32_t byte_fallback_start) {
  const Trie& t = *(const Trie*)handle;
  int64_t n = 0;
  int64_t i = 0;
  while (i < len && n < out_cap) {
    int32_t node = t.root_children[text[i]];
    int32_t best_id = -1;
    int64_t best_len = 0;
    int64_t j = i;
    while (node >= 0 && j < len) {
      j++;
      if (t.nodes[node].token_id >= 0) {
        best_id = t.nodes[node].token_id;
        best_len = j - i;
      }
      if (j < len) node = t.nodes[node].find(text[j]);
      else break;
    }
    if (best_id < 0) {
      if (byte_fallback_start >= 0) out[n++] = byte_fallback_start + text[i];
      i += 1;
    } else {
      out[n++] = best_id;
      i += best_len;
    }
  }
  return n;
}

}  // extern "C"
