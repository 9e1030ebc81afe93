// Native BPE merge loop for the CLIP tokenizer.
//
// The reference tokenizer is pure Python (ref: clip/simple_tokenizer.py);
// its hot path is the pairwise merge loop, which is quadratic in word
// length and dominates batch tokenization of long Long-CLIP prompts
// (248-token context).  This module implements only that loop — the
// unicode-regex pre-split stays in Python so tokenization parity is exact.
//
// C API (ctypes-friendly):
//   handle = bpe_create(symbols, ranks)
//     symbols: '\n'-joined symbol table (index == symbol id)
//     ranks:   '\n'-joined "first second" merge pairs, rank == line index
//   n = bpe_encode_word(handle, word_symbols_ids, n_in, out_ids, max_out)
//     word is given as symbol ids of its initial characters (last one the
//     '</w>'-suffixed variant); returns the merged symbol ids.
//   bpe_free(handle)
//
// Build: egm_unet_torch/native/__init__.py (g++ -O2 -shared -fPIC into
// egm_unet_torch/_build/ at first use).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<int32_t, int32_t>& p) const {
    return std::hash<int64_t>()((int64_t(p.first) << 32) ^ uint32_t(p.second));
  }
};

struct Bpe {
  std::unordered_map<std::string, int32_t> symbol_to_id;
  std::vector<std::string> id_to_symbol;
  std::unordered_map<std::pair<int32_t, int32_t>, int32_t, PairHash> rank;
  std::unordered_map<std::pair<int32_t, int32_t>, int32_t, PairHash> merged_id;
};

std::vector<std::string> split_lines(const char* text) {
  std::vector<std::string> out;
  const char* p = text;
  while (*p) {
    const char* nl = strchr(p, '\n');
    if (!nl) {
      out.emplace_back(p);
      break;
    }
    out.emplace_back(p, nl - p);
    p = nl + 1;
  }
  return out;
}

}  // namespace

extern "C" {

void* bpe_create(const char* symbols_text, const char* ranks_text) {
  auto* bpe = new Bpe();
  bpe->id_to_symbol = split_lines(symbols_text);
  for (size_t i = 0; i < bpe->id_to_symbol.size(); ++i)
    bpe->symbol_to_id[bpe->id_to_symbol[i]] = int32_t(i);

  auto rank_lines = split_lines(ranks_text);
  for (size_t r = 0; r < rank_lines.size(); ++r) {
    const std::string& line = rank_lines[r];
    size_t sp = line.find(' ');
    if (sp == std::string::npos) continue;
    std::string a = line.substr(0, sp), b = line.substr(sp + 1);
    auto ia = bpe->symbol_to_id.find(a);
    auto ib = bpe->symbol_to_id.find(b);
    auto im = bpe->symbol_to_id.find(a + b);
    if (ia == bpe->symbol_to_id.end() || ib == bpe->symbol_to_id.end() ||
        im == bpe->symbol_to_id.end())
      continue;
    std::pair<int32_t, int32_t> key{ia->second, ib->second};
    bpe->rank[key] = int32_t(r);
    bpe->merged_id[key] = im->second;
  }
  return bpe;
}

// word given as initial symbol ids; returns merged count, writes ids.
int32_t bpe_encode_word(void* handle, const int32_t* in_ids, int32_t n_in,
                        int32_t* out_ids, int32_t max_out) {
  auto* bpe = static_cast<Bpe*>(handle);
  std::vector<int32_t> word(in_ids, in_ids + n_in);

  while (word.size() > 1) {
    // find the lowest-rank adjacent pair
    int32_t best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < word.size(); ++i) {
      auto it = bpe->rank.find({word[i], word[i + 1]});
      if (it != bpe->rank.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT32_MAX) break;

    // merge ALL occurrences of that pair left-to-right (BPE semantics:
    // word.index(first, i) scan in the reference implementation)
    std::pair<int32_t, int32_t> pair{word[best_i], word[best_i + 1]};
    int32_t mid = bpe->merged_id[pair];
    std::vector<int32_t> next;
    next.reserve(word.size());
    size_t i = 0;
    while (i < word.size()) {
      if (i + 1 < word.size() && word[i] == pair.first &&
          word[i + 1] == pair.second) {
        next.push_back(mid);
        i += 2;
      } else {
        next.push_back(word[i]);
        i += 1;
      }
    }
    word.swap(next);
  }

  int32_t n = int32_t(word.size() < size_t(max_out) ? word.size() : max_out);
  memcpy(out_ids, word.data(), n * sizeof(int32_t));
  return n;
}

void bpe_free(void* handle) { delete static_cast<Bpe*>(handle); }

}  // extern "C"
