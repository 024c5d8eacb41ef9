// stair_tpu_torch native program parser + lowerer.
//
// Single-call batch path: annotation strings in, padded executor instruction
// tables out. Replicates the Python pipeline exactly —
// stair_tpu_torch/programs/parser.py (tokenize + rewrites) and
// stair_tpu_torch/ir/lowering.py (kind-tracked lowering to field matrices) — and is
// validated against it by tests/test_native_parser.py over every program the
// synthetic worlds and template corpora produce. When question text is
// supplied, free-text arguments are span-linked to question tokens with a
// port of the deterministic lemma-matching pipeline
// (stair_tpu_torch/programs/spans.py + text.py fallback; reference semantics
// utils/agqa_lite.py:62-119); without questions they lower to the
// whole-question-mean sentinel (-1). Programs outside the supported kind
// system return an error and the caller falls back to Python.
//
// Build: g++ -std=c++20 -O3 -shared -fPIC -pthread parser.cpp -o _parser.so

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <map>
#include <set>
#include <unordered_map>
#include <unordered_set>
#include <string>
#include <string_view>
#include <thread>
#include <vector>

namespace {

// Heterogeneous (string_view) lookup for the hot token tables.
struct SvHash {
  using is_transparent = void;
  size_t operator()(std::string_view sv) const {
    return std::hash<std::string_view>{}(sv);
  }
};
template <typename V>
using TokenMap =
    std::unordered_map<std::string, V, SvHash, std::equal_to<>>;
using TokenSet =
    std::unordered_set<std::string, SvHash, std::equal_to<>>;


// ---- opcode/field layout: must match stair_tpu_torch/ir/lowering.py -------------
enum Op {
  NOP = 0, PUSH_TEXT, AND_VEC, AND_ATTN, COMPARE, EQUALS, CHOOSE, XOR,
  XORFRAME, QUERY, TOACTION, HASITEM, EXISTS, EXISTSFRAME, LOCALIZE,
  SUPERLATIVE_V, SUPERLATIVE_F, TEMPORAL, ATTNVIDEO, FILTER_V, FILTER_K,
  FILTERFRAME_V, FILTERFRAME_K, RELATE,
};
constexpr int NFIELDS = 17;
enum Field {
  F_OPCODE = 0, F_VA, F_VB, F_VC, F_FA, F_FB, F_AA, F_AB, F_MODE, F_COUNT,
  F_SPAN_START, F_SPAN_END, F_OUT_VEC, F_OUT_FRAMES, F_OUT_ATTN,
  F_OUT_ATTN_B, F_SRC,
};
constexpr int SCRATCH = -1;

const TokenMap<int> kParseArity = {
    {"Array1", 1}, {"HasItem", 1}, {"OnlyItem", 1},
    {"Array2", 2}, {"AND", 2}, {"XOR", 2}, {"And", 2}, {"Xor", 2},
    {"Compare", 2}, {"Equals", 2}, {"Exists", 2}, {"Filter", 2},
    {"Iterate", 2}, {"Localize", 2}, {"ToAction", 2}, {"Query", 2},
    {"Subtract", 2},
    {"Array3", 3}, {"Superlative", 3}, {"Choose", 3},
    {"IterateUntil", 4},
};

TokenMap<int> MakeNmnArity() {
  TokenMap<int> m = kParseArity;
  m["Query"] = 1;
  m["Relate"] = 2; m["AttnVideo"] = 2; m["FilterFrame"] = 2;
  m["ExistsFrame"] = 2; m["XorFrame"] = 2; m["Temporal"] = 3;
  m.erase("Subtract");
  return m;
}
const TokenMap<int> kNmnArity = MakeNmnArity();

const TokenMap<int> kTemporalModes = {
    {"while", 0}, {"before", 1}, {"after", 2}, {"between", 3}};
const TokenMap<int> kRelateModes = {
    {"forward", 0}, {"backward", 1}};
const TokenMap<int> kSuperlativeModes = {{"max", 0}, {"min", 1}};
const TokenMap<int> kTypeKeywords = {
    {"actions", 0}, {"objects", 1}, {"relations", 2}};
const TokenSet kStackKeywords = {
    "while", "before", "after", "between", "forward", "backward",
    "max", "min", "actions", "objects", "relations", "start", "end"};

struct Cell {
  std::string_view tok;
  int src;  // original token index or -1
};

// ---- tokenizer (parser.py:tokenize_annotation) ----------------------------
// Returns false on malformed bracket nesting (caller falls back to Python,
// which raises cleanly) — a bad annotation string must never be UB here.
bool Tokenize(const std::string& input, std::vector<std::string>* result) {
  // Single pass over the annotation, emitting the ';'-separated segments
  // of the original two-pass formulation directly (", "/"("/bracket edges
  // are delimiters, ' ' -> '_', ')' dropped; every delimiter emits a
  // segment, including empty ones — quirk preserved from the Python
  // tokenizer, parser.py:tokenize_annotation).
  std::vector<std::string> raw;
  raw.reserve(input.size() / 4 + 4);
  std::string cur;
  for (size_t i = 0; i < input.size(); ++i) {
    char c = input[i];
    if (c == ',' && i + 1 < input.size() && input[i + 1] == ' ') {
      raw.push_back(std::move(cur));
      cur.clear();
      ++i;
    } else if (c == ' ') {
      cur += '_';
    } else if (c == '(') {
      raw.push_back(std::move(cur));
      cur.clear();
    } else if (c == ')') {
      // dropped
    } else if (c == '[') {
      cur += '[';
      raw.push_back(std::move(cur));
      cur.clear();
    } else if (c == ']') {
      raw.push_back(std::move(cur));
      cur = "]";
    } else {
      cur += c;
    }
  }
  raw.push_back(std::move(cur));
  // Bracket -> ArrayN (top-level item count).
  std::vector<std::string> out;
  out.reserve(raw.size());
  std::vector<size_t> open;
  for (auto& tok : raw) {
    if (tok == "[") {
      open.push_back(out.size());
      out.push_back(std::move(tok));
    } else if (tok == "]") {
      if (open.empty()) return false;  // unmatched ']'
      size_t b = open.back();
      open.pop_back();
      int items = static_cast<int>(out.size() - b - 1);
      for (size_t j = b + 1; j < out.size(); ++j) {
        auto it = kParseArity.find(std::string_view(out[j]));
        if (it != kParseArity.end()) items -= it->second;
      }
      out[b] = "Array" + std::to_string(items);
    } else {
      out.push_back(std::move(tok));
    }
  }
  if (!open.empty()) return false;  // unmatched '['
  *result = std::move(out);
  return true;
}

// ---- tree utilities --------------------------------------------------------
// Returns false when an op's arity exceeds the available operands (malformed
// program) — on success every op node has exactly its arity in kids.
bool ChildrenParents(const std::vector<Cell>& prog,
                     std::vector<std::vector<int>>* kids,
                     std::vector<int>* parents) {
  int n = static_cast<int>(prog.size());
  kids->assign(n, {});
  parents->assign(n, 0);
  std::vector<int> stack;
  for (int i = n - 1; i >= 0; --i) {
    auto it = kNmnArity.find(prog[i].tok);
    if (it == kNmnArity.end()) {
      stack.push_back(i);
    } else {
      for (int a = 0; a < it->second; ++a) {
        if (stack.empty()) return false;  // operand underflow
        (*kids)[i].push_back(stack.back());
        stack.pop_back();
      }
      stack.push_back(i);
    }
  }
  for (int i = 0; i < n; ++i)
    for (int c : (*kids)[i]) (*parents)[c] = i;
  return true;
}

std::vector<int> Subtree(const std::vector<std::vector<int>>& kids, int pos) {
  std::vector<int> acc = {pos};
  std::vector<int> frontier(kids[pos]);
  while (!frontier.empty()) {
    int p = frontier.back();
    frontier.pop_back();
    acc.push_back(p);
    for (int c : kids[p]) frontier.push_back(c);
  }
  std::sort(acc.begin(), acc.end());
  return acc;
}

// ---- rewrites (parser.py:_linear_rewrites / _rewrite_*) --------------------
bool LinearRewrites(std::vector<Cell>* prog, std::vector<int>* iterate_marks) {
  auto& p = *prog;
  size_t i = 0;
  while (i < p.size()) {
    const std::string_view t = p[i].tok;
    if (t == "OnlyItem" || t == "Array1") {
      p.erase(p.begin() + i);
      continue;
    }
    if (t == "XOR") {
      p[i].tok = "Xor";
    } else if (t == "AND") {
      p[i].tok = "And";
    } else if (t == "relation") {
      p[i].tok = "relations";
    } else if (t == "Query" && i + 1 < p.size() && p[i + 1].tok == "class") {
      p.erase(p.begin() + i, p.begin() + i + 2);
      continue;
    } else if (t == "Subtract") {
      if (i + 7 > p.size()) return false;
      p.erase(p.begin() + i + 1, p.begin() + i + 7);
      p[i] = {"video", -1};
    } else if (t == "Iterate") {
      iterate_marks->push_back(static_cast<int>(i));
    } else if (t == "Localize") {
      if (i + 2 > p.size()) return false;
      int mode_src = p[i + 1].src;
      p[i + 1].src = -1;
      p[i].tok = "Temporal";
      std::vector<Cell> ins = {
          {"video", -1}, {"Localize", mode_src}, {"video", -1}};
      p.insert(p.begin() + i + 2, ins.begin(), ins.end());
      i += 4;
      continue;
    } else if (t == "Array3") {
      if (i + 4 > p.size()) return false;
      p.erase(p.begin() + i + 3);
      p.erase(p.begin() + i + 1);
      p.erase(p.begin() + i);
      continue;
    } else if (t == "Array2" && i + 1 < p.size() && p[i + 1].tok == "actions") {
      p.erase(p.begin() + i, p.begin() + i + 2);
      continue;
    } else if (t == "Superlative" && i + 2 < p.size() &&
               p[i + 2].tok == "Filter") {
      p[i + 2].tok = "FilterFrame";
    }
    ++i;
  }
  return true;
}

bool RewriteIterate(std::vector<Cell>* prog, const std::vector<int>& marks) {
  std::vector<std::vector<int>> kids;
  std::vector<int> parents;
  if (!ChildrenParents(*prog, &kids, &parents)) return false;
  std::set<int> dead;
  for (int pos : marks) {
    if (kids[pos].size() < 2) return false;
    (*prog)[pos].tok = "Filter";
    int inner = kids[pos][1];
    dead.insert(inner);
    dead.insert(inner + 1);
  }
  std::vector<Cell> out;
  for (int i = 0; i < static_cast<int>(prog->size()); ++i)
    if (!dead.count(i)) out.push_back((*prog)[i]);
  *prog = out;
  return true;
}

bool RewriteIterateUntil(std::vector<Cell>* prog) {
  for (;;) {
    std::vector<int> iu;
    for (int i = 0; i < static_cast<int>(prog->size()); ++i)
      if ((*prog)[i].tok == "IterateUntil") iu.push_back(i);
    if (iu.empty()) return true;
    std::vector<std::vector<int>> kids;
    std::vector<int> parents;
    if (!ChildrenParents(*prog, &kids, &parents)) return false;
    int best_start = -1, best_end = -1;
    for (int p : iu) {
      auto span = Subtree(kids, p);
      int s = span.front(), e = span.back() + 1;
      if (best_start < 0 || e - s < best_end - best_start) {
        best_start = s;
        best_end = e;
      }
    }
    int start = best_start, end = best_end;
    auto& pr = *prog;
    if (kids[start].size() < 4) return false;
    std::vector<Cell> seg = {{"Filter", pr[start].src}, {"AttnVideo", -1}};
    int items_len = static_cast<int>(Subtree(kids, kids[start][1]).size());
    if (start + 2 + items_len > static_cast<int>(pr.size())) return false;
    for (int j = start + 2; j < start + 2 + items_len; ++j)
      seg.push_back(pr[j]);
    seg.push_back({"Relate", -1});
    seg.push_back(pr[start + 1]);
    for (int bfi : Subtree(kids, kids[start][2])) {
      const Cell& c = pr[bfi];
      if (c.tok == "frame") {
        seg.push_back({"video", c.src});
      } else if (c.tok == "Filter" && bfi + 1 < static_cast<int>(pr.size()) &&
                 pr[bfi + 1].tok == "frame") {
        if (pr[parents[bfi]].tok == "Exists") {
          size_t back = static_cast<size_t>(bfi - parents[bfi]);
          if (back < 1 || back > seg.size()) return false;
          seg[seg.size() - back].tok = "ExistsFrame";
        }
        seg.push_back({"FilterFrame", c.src});
      } else if (c.tok == "Xor") {
        seg.push_back({"XorFrame", c.src});
      } else {
        seg.push_back(c);
      }
    }
    if (kids[kids[start][3]].size() < 2) return false;
    for (int p2 : Subtree(kids, kids[kids[start][3]][1]))
      seg.push_back(pr[p2]);
    if (static_cast<int>(seg.size()) != end - start) return false;
    std::vector<Cell> out(pr.begin(), pr.begin() + start);
    out.insert(out.end(), seg.begin(), seg.end());
    out.insert(out.end(), pr.begin() + end, pr.end());
    *prog = out;
  }
}

bool RewriteCompare(std::vector<Cell>* prog) {
  auto& p = *prog;
  if (p.size() < 4) return false;
  p.erase(p.begin() + 1, p.begin() + 4);
  int tag = -1;
  for (int i = 0; i < static_cast<int>(p.size()); ++i)
    if (p[i].tok == "temporal_tag") { tag = i; break; }
  if (tag < 0) return false;
  int body = static_cast<int>(p.size());
  std::vector<Cell> doubled(p);
  doubled.insert(doubled.end(), p.begin() + 1, p.end());
  doubled[tag].tok = "before";
  doubled[tag + body - 1].tok = "after";
  *prog = doubled;
  return true;
}

// ---- question span linking --------------------------------------------------
// Port of stair_tpu_torch/programs/spans.py + the deterministic fallback text
// pipeline in stair_tpu_torch/programs/text.py (regex word tokenizer, suffix
// POS tagger, rule lemmatizer). Mirrors the reference span semantics
// (utils/agqa_lite.py:62-119) exactly as the Python fallback implements
// them — including the exclusive-last-start quirk of _find_subsequence.
namespace spanlink {

inline bool WordChar(char c) {
  return std::isalnum(static_cast<unsigned char>(c)) || c == '_';
}

inline std::string Lower(const std::string& s) {
  std::string out(s);
  for (auto& c : out) c = std::tolower(static_cast<unsigned char>(c));
  return out;
}

const char* kContractions[] = {"n't", "'ll", "'re", "'ve", "'s", "'m", "'d"};

bool SuffixAt(const std::string& chunk, size_t p, const char* sfx,
              size_t* sfx_len) {
  size_t n = std::strlen(sfx);
  if (p + n > chunk.size()) return false;
  for (size_t i = 0; i < n; ++i) {
    char a = std::tolower(static_cast<unsigned char>(chunk[p + i]));
    if (a != sfx[i]) return false;
  }
  if (p + n < chunk.size() && WordChar(chunk[p + n])) return false;  // \b
  *sfx_len = n;
  return true;
}

void RegexTokens(const std::string& s, std::vector<std::string>* out) {
  // \w+|[^\w\s] scan.
  size_t i = 0;
  while (i < s.size()) {
    char c = s[i];
    if (std::isspace(static_cast<unsigned char>(c))) { ++i; continue; }
    if (WordChar(c)) {
      size_t j = i;
      while (j < s.size() && WordChar(s[j])) ++j;
      out->push_back(s.substr(i, j - i));
      i = j;
    } else {
      out->push_back(s.substr(i, 1));
      ++i;
    }
  }
}

std::vector<std::string> TextTokenize(const std::string& sentence) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < sentence.size()) {
    while (i < sentence.size() &&
           std::isspace(static_cast<unsigned char>(sentence[i]))) ++i;
    size_t j = i;
    while (j < sentence.size() &&
           !std::isspace(static_cast<unsigned char>(sentence[j]))) ++j;
    if (j == i) break;
    std::string chunk = sentence.substr(i, j - i);
    i = j;
    // re.match(r"(?i)\b(\w+)(n't|'ll|'re|'ve|'s|'m|'d)\b", chunk): greedy
    // \w+ -> take the LARGEST split point whose suffix matches.
    size_t best_p = 0, best_sfx = 0;
    if (!chunk.empty() && WordChar(chunk[0])) {
      size_t wlen = 0;
      while (wlen < chunk.size() && WordChar(chunk[wlen])) ++wlen;
      for (size_t p = wlen; p >= 1 && best_p == 0; --p) {
        for (const char* sfx : kContractions) {
          size_t n;
          if (SuffixAt(chunk, p, sfx, &n)) { best_p = p; best_sfx = n; break; }
        }
      }
    }
    if (best_p > 0) {
      out.push_back(chunk.substr(0, best_p));
      out.push_back(chunk.substr(best_p, best_sfx));
      RegexTokens(chunk.substr(best_p + best_sfx), &out);
    } else {
      RegexTokens(chunk, &out);
    }
  }
  return out;
}

// text.py:_FUNCTION_WORDS (word -> POS tag).
const std::unordered_map<std::string, std::string> kFunctionWords = {
    {"the", "DT"}, {"a", "DT"}, {"an", "DT"}, {"some", "DT"}, {"this", "DT"},
    {"that", "DT"}, {"these", "DT"}, {"those", "DT"},
    {"they", "PRP"}, {"he", "PRP"}, {"she", "PRP"}, {"it", "PRP"},
    {"i", "PRP"}, {"we", "PRP"}, {"you", "PRP"}, {"person", "NN"},
    {"in", "IN"}, {"on", "IN"}, {"at", "IN"}, {"of", "IN"}, {"to", "TO"},
    {"before", "IN"}, {"after", "IN"}, {"while", "IN"}, {"between", "IN"},
    {"and", "CC"}, {"or", "CC"}, {"but", "CC"},
    {"did", "VBD"}, {"do", "VB"}, {"does", "VBZ"}, {"was", "VBD"},
    {"were", "VBD"}, {"is", "VBZ"}, {"are", "VBP"}, {"be", "VB"},
    {"been", "VBN"},
    {"which", "WDT"}, {"what", "WP"}, {"who", "WP"}, {"how", "WRB"},
    {"when", "WRB"}, {"where", "WRB"}, {"why", "WRB"},
    {"first", "JJ"}, {"last", "JJ"}, {"longest", "JJS"}, {"shortest", "JJS"},
    {"not", "RB"}, {"no", "DT"}, {"yes", "UH"},
    {"their", "PRP$"}, {"his", "PRP$"}, {"her", "PRP$"}, {"its", "PRP$"},
    {"?", "."}, {".", "."}, {",", ","},
};

const std::unordered_set<std::string> kIrregularVerbs = {
    "took", "held", "ate", "sat", "stood", "threw", "put", "ran", "lay",
    "went", "drank", "began", "got", "left", "made", "opened", "closed"};

bool EndsWith(const std::string& s, const char* sfx) {
  size_t n = std::strlen(sfx);
  return s.size() >= n && s.compare(s.size() - n, n, sfx) == 0;
}

std::string PosTag(const std::string& word) {
  std::string lw = Lower(word);
  auto it = kFunctionWords.find(lw);
  if (it != kFunctionWords.end()) return it->second;
  if (kIrregularVerbs.count(lw)) return "VBD";
  if (EndsWith(lw, "ing")) return "VBG";
  if (EndsWith(lw, "ed")) return "VBD";
  if (EndsWith(lw, "ly")) return "RB";
  if (EndsWith(lw, "est")) return "JJS";
  return "NN";
}

// text.py:_VERB_LEMMAS / _NOUN_LEMMAS.
const std::unordered_map<std::string, std::string> kVerbLemmas = {
    {"took", "take"}, {"taken", "take"}, {"taking", "take"},
    {"held", "hold"}, {"holding", "hold"},
    {"ate", "eat"}, {"eaten", "eat"}, {"eating", "eat"},
    {"sat", "sit"}, {"sitting", "sit"},
    {"stood", "stand"}, {"standing", "stand"},
    {"threw", "throw"}, {"thrown", "throw"}, {"throwing", "throw"},
    {"putting", "put"}, {"ran", "run"}, {"running", "run"},
    {"lay", "lie"}, {"lying", "lie"}, {"laying", "lay"},
    {"went", "go"}, {"going", "go"}, {"gone", "go"},
    {"drank", "drink"}, {"drunk", "drink"}, {"drinking", "drink"},
    {"began", "begin"}, {"begun", "begin"}, {"beginning", "begin"},
    {"got", "get"}, {"gotten", "get"}, {"getting", "get"},
    {"left", "leave"}, {"leaving", "leave"},
    {"made", "make"}, {"making", "make"},
    {"was", "be"}, {"were", "be"}, {"is", "be"}, {"are", "be"},
    {"been", "be"},
    {"did", "do"}, {"done", "do"}, {"doing", "do"},
    {"had", "have"}, {"has", "have"}, {"having", "have"},
    {"grasping", "grasp"}, {"snuggling", "snuggle"}, {"smiling", "smile"},
    {"sneezing", "sneeze"}, {"washing", "wash"}, {"watching", "watch"},
    {"opening", "open"}, {"closing", "close"}, {"tidying", "tidy"},
    {"wiping", "wipe"}, {"pouring", "pour"}, {"playing", "play"},
    {"touching", "touch"}, {"turning", "turn"}, {"walking", "walk"},
    {"working", "work"}, {"dressing", "dress"}, {"fixing", "fix"},
    {"awakening", "awaken"}, {"laughing", "laugh"}, {"cooking", "cook"},
    {"reaching", "reach"}, {"leaning", "lean"}, {"carrying", "carry"},
    {"covering", "cover"}, {"undressing", "undress"},
    {"photographing", "photograph"}, {"talking", "talk"},
    {"looking", "look"}, {"starting", "start"},
};

const std::unordered_map<std::string, std::string> kNounLemmas = {
    {"dishes", "dish"}, {"boxes", "box"}, {"glasses", "glass"},
    {"shoes", "shoe"}, {"clothes", "clothes"}, {"groceries", "grocery"},
    {"shelves", "shelf"}, {"feet", "foot"}, {"children", "child"},
    {"people", "person"},
};

inline bool Vowel(char c) {
  return c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u';
}

bool EndsWithAny(const std::string& s,
                 std::initializer_list<const char*> sfxs) {
  for (const char* sfx : sfxs)
    if (EndsWith(s, sfx)) return true;
  return false;
}

std::string StripVerbSuffix(const std::string& w) {
  if (EndsWith(w, "ing") && w.size() > 5) {
    std::string stem = w.substr(0, w.size() - 3);
    if (stem.size() >= 3 && stem[stem.size() - 1] == stem[stem.size() - 2] &&
        !Vowel(stem.back()))
      return stem.substr(0, stem.size() - 1);
    if (EndsWithAny(stem, {"at", "iv", "ak", "in", "id", "os", "ut", "ap"}))
      return stem + "e";
    return stem;
  }
  if (EndsWith(w, "ied") && w.size() > 4) return w.substr(0, w.size() - 3) + "y";
  if (EndsWith(w, "ed") && w.size() > 4) {
    std::string stem = w.substr(0, w.size() - 2);
    if (stem.size() >= 3 && stem[stem.size() - 1] == stem[stem.size() - 2] &&
        !Vowel(stem.back()))
      return stem.substr(0, stem.size() - 1);
    if (EndsWithAny(stem, {"at", "iv", "os", "ut"})) return stem + "e";
    return stem;
  }
  if (EndsWith(w, "s") && !EndsWithAny(w, {"ss", "us", "is"}))
    return w.substr(0, w.size() - 1);
  return w;
}

std::string StripNounSuffix(const std::string& w) {
  if (EndsWith(w, "ies") && w.size() > 4) return w.substr(0, w.size() - 3) + "y";
  if (EndsWithAny(w, {"ses", "xes", "zes", "ches", "shes"}))
    return w.substr(0, w.size() - 2);
  if (EndsWith(w, "s") && !EndsWithAny(w, {"ss", "us", "is"}))
    return w.substr(0, w.size() - 1);
  return w;
}

std::string Lemmatize(const std::string& word, char pos) {
  std::string lw = Lower(word);
  if (pos == 'v') {
    auto it = kVerbLemmas.find(lw);
    if (it != kVerbLemmas.end()) return it->second;
    return StripVerbSuffix(lw);
  }
  auto it = kNounLemmas.find(lw);
  if (it != kNounLemmas.end()) return it->second;
  return StripNounSuffix(lw);
}

// spans.py:QUESTION_WORD_RULES / PROGRAM_WORD_RULES.
const std::unordered_map<std::string, std::string> kQuestionRules = {
    {"consume", "eat"}, {"consuming", "eat"}, {"ate", "eat"},
    {"taking", "take"}, {"sneezing", "sneeze"}, {"drank", "drink"},
    {"wiping", "wipe"}, {"drinking", "drink"}, {"closing", "close"},
    {"lay", "lie"},
};
const std::unordered_map<std::string, std::string> kProgramRules = {
    {"opening", "open"}, {"closing", "close"}, {"sitting on", "sit"},
    {"playing on", "play"}, {"drinking", "drink"}, {"putting down", "put"},
    {"consuming", "eat"},
};

std::string NormalizeQuestionWordUncached(const std::string& w0) {
  auto r = kQuestionRules.find(w0);
  const std::string& w = (r != kQuestionRules.end()) ? r->second : w0;
  std::string tag = EndsWith(w, "ing") ? "V" : PosTag(w);
  char p = std::tolower(static_cast<unsigned char>(tag[0]));
  if ((p == 'v' || p == 'n') && w != "clothes") return Lemmatize(w, p);
  return w;
}

std::vector<std::string> NormalizeQuestion(const std::string& question) {
  // Word -> normalized-word is a pure function; question vocabulary is
  // small and repeats across a batch, so memoize it (thread-local: the
  // batch entry point fans work across threads).
  thread_local std::unordered_map<std::string, std::string> memo;
  std::vector<std::string> words = TextTokenize(question);
  std::vector<std::string> out;
  out.reserve(words.size());
  for (auto& w0 : words) {
    auto it = memo.find(w0);
    if (it == memo.end())
      it = memo.emplace(w0, NormalizeQuestionWordUncached(w0)).first;
    out.push_back(it->second);
  }
  return out;
}

std::vector<std::string> NormalizeProgramUncached(const std::string& token) {
  std::string phrase(token);
  for (auto& c : phrase)
    if (c == '_') c = ' ';
  auto r = kProgramRules.find(phrase);
  if (r != kProgramRules.end()) phrase = r->second;
  std::vector<std::string> words = TextTokenize(phrase);
  std::vector<std::string> out;
  out.reserve(words.size());
  for (auto& w0 : words) {
    auto rw = kProgramRules.find(w0);
    const std::string& w = (rw != kProgramRules.end()) ? rw->second : w0;
    std::string tag = PosTag(w);
    if (tag[0] == 'V' || tag[0] == 'N') {
      out.push_back(Lemmatize(
          w, std::tolower(static_cast<unsigned char>(tag[0]))));
    } else {
      out.push_back(w);
    }
  }
  return out;
}

const std::vector<std::string>& NormalizeProgram(const std::string& token) {
  // Free-text program arguments come from a small closed vocabulary
  // (AGQA object/action/relation names, ~200 strings) — memoize.
  thread_local std::unordered_map<std::string, std::vector<std::string>> memo;
  auto it = memo.find(token);
  if (it == memo.end())
    it = memo.emplace(token, NormalizeProgramUncached(token)).first;
  return it->second;
}

// spans.py:_find_subsequence — note range(len(h) - len(n)): the last legal
// start position is deliberately excluded (reference parity quirk).
int FindSubsequence(const std::vector<std::string>& hay,
                    const std::vector<std::string>& needle) {
  int limit = static_cast<int>(hay.size()) - static_cast<int>(needle.size());
  for (int i = 0; i < limit; ++i) {
    bool ok = true;
    for (size_t j = 0; j < needle.size(); ++j)
      if (hay[i + j] != needle[j]) { ok = false; break; }
    if (ok) return i;
  }
  return -1;
}

}  // namespace spanlink

// Tokens the span linker skips (parser.py ALL_RESERVED members that can
// reach the PUSH_TEXT branch).
const TokenSet kSpanSkip = {"frame", "class", "temporal_tag"};

// ---- lowering (lowering.py:lower_program) ----------------------------------
enum Kind { K_VEC, K_FRAMES, K_ATTN, K_KW };
struct Val {
  Kind kind;
  int r0 = 0, r1 = 0;
  int nregs = 1;
  std::string_view kw;
};

struct Meta {
  int steps, num_vec, num_frames, num_attn, root_reg, root_is_vec;
};

// Supervised module families (Exists/Xor/Equals/Filter/ToAction/
// FilterFrame/ExistsFrame/Superlative/Localize/Temporal) by opcode.
bool SupervisedOp(int op) {
  switch (op) {
    case EQUALS: case XOR: case TOACTION: case EXISTS: case EXISTSFRAME:
    case LOCALIZE: case SUPERLATIVE_V: case SUPERLATIVE_F: case TEMPORAL:
    case FILTER_V: case FILTER_K: case FILTERFRAME_V: case FILTERFRAME_K:
      return true;
    default:
      return false;
  }
}

bool ProducesVec(int op) {
  switch (op) {
    case PUSH_TEXT: case AND_VEC: case COMPARE: case EQUALS: case CHOOSE:
    case XOR: case QUERY: case TOACTION: case EXISTS: case FILTER_V:
    case FILTER_K: case SUPERLATIVE_V: case SUPERLATIVE_F:
      return true;
    default:
      return false;
  }
}
bool ProducesFrames(int op) {
  return op == TEMPORAL || op == ATTNVIDEO || op == FILTERFRAME_V ||
         op == FILTERFRAME_K;
}
bool ProducesAttn(int op) {
  switch (op) {
    case AND_ATTN: case XORFRAME: case HASITEM: case EXISTSFRAME:
    case LOCALIZE: case RELATE:
      return true;
    default:
      return false;
  }
}

bool Lower(const std::vector<Cell>& prog, int cap_steps,
           int32_t* fields /* cap_steps x NFIELDS */, uint8_t* supervised,
           Meta* meta,
           const std::vector<std::string>* norm_question = nullptr,
           bool aux_missing = false) {
  int nv = 0, nf = 1, na = 0;  // frames reg 0 = video
  std::vector<Val> stack;
  struct Row { int32_t f[NFIELDS]; uint8_t sup; };
  std::vector<Row> rows;

  auto new_row = [&](int op, int src) {
    Row r;
    for (int j = 0; j < NFIELDS; ++j) r.f[j] = 0;
    r.f[F_OPCODE] = op;
    r.f[F_COUNT] = 1;
    r.f[F_SPAN_START] = -1;
    r.f[F_SPAN_END] = -1;
    r.f[F_SRC] = src;
    r.sup = 0;
    return r;
  };
  auto pop = [&]() { Val v = stack.back(); stack.pop_back(); return v; };

  int n = static_cast<int>(prog.size());
  for (int pos = n - 1; pos >= 0; --pos) {
    const std::string_view t = prog[pos].tok;
    int src = prog[pos].src;
    auto ar = kNmnArity.find(t);
    if (ar == kNmnArity.end()) {
      if (t == "video") {
        stack.push_back({K_FRAMES, 0, 0, 1, ""});
      } else if (kStackKeywords.count(t)) {
        Val v;
        v.kind = K_KW;
        v.kw = t;
        stack.push_back(v);
      } else {
        Row r = new_row(PUSH_TEXT, src);
        r.f[F_OUT_VEC] = nv++;
        r.f[F_OUT_FRAMES] = SCRATCH;
        r.f[F_OUT_ATTN] = SCRATCH;
        r.f[F_OUT_ATTN_B] = SCRATCH;
        // Link the free-text argument to its question span
        // (lowering.py:249-252: missing span -> -1, or -2 in aux mode).
        int miss = aux_missing ? -2 : -1;
        r.f[F_SPAN_START] = miss;
        r.f[F_SPAN_END] = miss;
        if (norm_question != nullptr && !kSpanSkip.count(t)) {
          const auto& needle = spanlink::NormalizeProgram(std::string(t));
          int st = spanlink::FindSubsequence(*norm_question, needle);
          if (st >= 0) {
            r.f[F_SPAN_START] = st;
            r.f[F_SPAN_END] = st + static_cast<int>(needle.size());
          }
        }
        rows.push_back(r);
        stack.push_back({K_VEC, r.f[F_OUT_VEC], 0, 1, ""});
      }
      continue;
    }

    Row r = new_row(NOP, src);
    if (t == "Array2") {
      if (stack.size() < 2) return false;
      Val a = pop(), b = pop();
      if (a.kind == K_VEC && b.kind == K_VEC) {
        stack.push_back({K_VEC, a.r0, b.r0, 2, ""});
      } else if (a.kind == K_ATTN && b.kind == K_ATTN) {
        stack.push_back({K_ATTN, a.r0, b.r0, 2, ""});
      } else {
        return false;
      }
      continue;
    }
    if (stack.size() < static_cast<size_t>(ar->second)) return false;

    if (t == "And" || t == "Xor") {
      Val a = pop(), b = pop();
      if (a.kind == K_VEC && b.kind == K_VEC && a.nregs == 1 && b.nregs == 1) {
        r.f[F_OPCODE] = (t == "And") ? AND_VEC : XOR;
        r.f[F_VA] = a.r0; r.f[F_VB] = b.r0;
        r.f[F_OUT_VEC] = nv++;
        stack.push_back({K_VEC, r.f[F_OUT_VEC], 0, 1, ""});
      } else if (a.kind == K_ATTN && b.kind == K_ATTN) {
        r.f[F_OPCODE] = (t == "And") ? AND_ATTN : XORFRAME;
        r.f[F_AA] = a.r0; r.f[F_AB] = b.r0;
        r.f[F_OUT_ATTN] = na++;
        stack.push_back({K_ATTN, r.f[F_OUT_ATTN], 0, 1, ""});
      } else {
        return false;
      }
    } else if (t == "XorFrame") {
      Val a = pop(), b = pop();
      if (a.kind != K_ATTN || b.kind != K_ATTN) return false;
      r.f[F_OPCODE] = XORFRAME;
      r.f[F_AA] = a.r0; r.f[F_AB] = b.r0;
      r.f[F_OUT_ATTN] = na++;
      stack.push_back({K_ATTN, r.f[F_OUT_ATTN], 0, 1, ""});
    } else if (t == "Compare" || t == "Equals" || t == "ToAction") {
      Val a = pop(), b = pop();
      if (a.kind != K_VEC || b.kind != K_VEC || a.nregs != 1 || b.nregs != 1)
        return false;
      r.f[F_OPCODE] = (t == "Compare") ? COMPARE
                     : (t == "Equals") ? EQUALS : TOACTION;
      r.f[F_VA] = a.r0; r.f[F_VB] = b.r0;
      r.f[F_OUT_VEC] = nv++;
      stack.push_back({K_VEC, r.f[F_OUT_VEC], 0, 1, ""});
    } else if (t == "Choose") {
      Val a = pop(), b = pop(), c = pop();
      if (a.kind != K_VEC || b.kind != K_VEC || c.kind != K_VEC) return false;
      r.f[F_OPCODE] = CHOOSE;
      r.f[F_VA] = a.r0; r.f[F_VB] = b.r0; r.f[F_VC] = c.r0;
      r.f[F_OUT_VEC] = nv++;
      stack.push_back({K_VEC, r.f[F_OUT_VEC], 0, 1, ""});
    } else if (t == "Query") {
      Val a = pop();
      if (a.kind != K_VEC) return false;
      r.f[F_OPCODE] = QUERY;
      r.f[F_VA] = a.r0;
      r.f[F_OUT_VEC] = nv++;
      stack.push_back({K_VEC, r.f[F_OUT_VEC], 0, 1, ""});
    } else if (t == "HasItem") {
      Val a = pop();
      if (a.kind != K_FRAMES) return false;
      r.f[F_OPCODE] = HASITEM;
      r.f[F_FA] = a.r0;
      r.f[F_OUT_ATTN] = na++;
      stack.push_back({K_ATTN, r.f[F_OUT_ATTN], 0, 1, ""});
    } else if (t == "Exists") {
      Val kw = pop(), feat = pop();
      if (kw.kind != K_VEC || feat.kind != K_VEC) return false;
      r.f[F_OPCODE] = EXISTS;
      r.f[F_VA] = kw.r0; r.f[F_VB] = feat.r0;
      r.f[F_OUT_VEC] = nv++;
      stack.push_back({K_VEC, r.f[F_OUT_VEC], 0, 1, ""});
    } else if (t == "ExistsFrame") {
      Val kw = pop(), feat = pop();
      if (kw.kind != K_VEC || feat.kind != K_FRAMES) return false;
      r.f[F_OPCODE] = EXISTSFRAME;
      r.f[F_VA] = kw.r0; r.f[F_FA] = feat.r0;
      r.f[F_OUT_ATTN] = na++;
      stack.push_back({K_ATTN, r.f[F_OUT_ATTN], 0, 1, ""});
    } else if (t == "Localize") {
      Val feat = pop(), kw = pop();
      if (feat.kind != K_FRAMES || kw.kind != K_VEC) return false;
      r.f[F_OPCODE] = LOCALIZE;
      r.f[F_FA] = feat.r0;
      r.f[F_COUNT] = kw.nregs;
      r.f[F_VA] = kw.r0;
      r.f[F_VB] = (kw.nregs == 2) ? kw.r1 : kw.r0;
      r.f[F_OUT_ATTN] = na++;
      r.f[F_OUT_ATTN_B] = (kw.nregs == 2) ? na++ : r.f[F_OUT_ATTN];
      Val out{K_ATTN, r.f[F_OUT_ATTN], r.f[F_OUT_ATTN_B], kw.nregs, ""};
      stack.push_back(out);
    } else if (t == "Superlative") {
      Val mode = pop();
      if (mode.kind != K_KW || !kSuperlativeModes.count(mode.kw)) return false;
      r.f[F_MODE] = kSuperlativeModes.find(mode.kw)->second;
      Val actions = pop();
      if (actions.kind == K_VEC) {
        r.f[F_OPCODE] = SUPERLATIVE_V;
        r.f[F_COUNT] = actions.nregs;
        r.f[F_VA] = actions.r0;
        r.f[F_VB] = (actions.nregs == 2) ? actions.r1 : actions.r0;
      } else if (actions.kind == K_FRAMES) {
        r.f[F_OPCODE] = SUPERLATIVE_F;
        r.f[F_FB] = actions.r0;
      } else {
        return false;
      }
      Val feat = pop();
      if (feat.kind != K_FRAMES) return false;
      r.f[F_FA] = feat.r0;
      r.f[F_OUT_VEC] = nv++;
      stack.push_back({K_VEC, r.f[F_OUT_VEC], 0, 1, ""});
    } else if (t == "Temporal") {
      Val mode = pop();
      if (mode.kind != K_KW || !kTemporalModes.count(mode.kw)) return false;
      r.f[F_MODE] = kTemporalModes.find(mode.kw)->second;
      Val feat = pop();
      if (feat.kind != K_FRAMES) return false;
      r.f[F_FA] = feat.r0;
      Val attn = pop();
      if (attn.kind != K_ATTN) return false;
      r.f[F_OPCODE] = TEMPORAL;
      r.f[F_COUNT] = attn.nregs;
      r.f[F_AA] = attn.r0;
      r.f[F_AB] = (attn.nregs == 2) ? attn.r1 : attn.r0;
      r.f[F_OUT_FRAMES] = nf++;
      r.f[F_OUT_ATTN_B] = na++;
      stack.push_back({K_FRAMES, r.f[F_OUT_FRAMES], 0, 1, ""});
    } else if (t == "AttnVideo") {
      Val feat = pop();
      if (feat.kind != K_FRAMES) return false;
      Val attn = pop();
      if (attn.kind != K_ATTN || attn.nregs != 1) return false;
      r.f[F_OPCODE] = ATTNVIDEO;
      r.f[F_FA] = feat.r0;
      r.f[F_AA] = attn.r0;
      r.f[F_OUT_FRAMES] = nf++;
      stack.push_back({K_FRAMES, r.f[F_OUT_FRAMES], 0, 1, ""});
    } else if (t == "Filter" || t == "FilterFrame") {
      bool frame = (t == "FilterFrame");
      Val feat = pop();
      if (feat.kind != K_FRAMES) return false;
      r.f[F_FA] = feat.r0;
      Val kw = pop();
      if (kw.kind == K_VEC && kw.nregs == 1) {
        r.f[F_OPCODE] = frame ? FILTERFRAME_V : FILTER_V;
        r.f[F_VA] = kw.r0;
      } else if (kw.kind == K_KW && kTypeKeywords.count(kw.kw)) {
        r.f[F_OPCODE] = frame ? FILTERFRAME_K : FILTER_K;
        r.f[F_MODE] = kTypeKeywords.find(kw.kw)->second;
      } else {
        return false;
      }
      if (frame) {
        r.f[F_OUT_FRAMES] = nf++;
        stack.push_back({K_FRAMES, r.f[F_OUT_FRAMES], 0, 1, ""});
      } else {
        r.f[F_OUT_VEC] = nv++;
        stack.push_back({K_VEC, r.f[F_OUT_VEC], 0, 1, ""});
      }
    } else if (t == "Relate") {
      Val mode = pop();
      if (mode.kind != K_KW || !kRelateModes.count(mode.kw)) return false;
      r.f[F_MODE] = kRelateModes.find(mode.kw)->second;
      Val attn = pop();
      if (attn.kind != K_ATTN) return false;
      r.f[F_OPCODE] = RELATE;
      r.f[F_AA] = attn.r0;
      r.f[F_OUT_ATTN] = na++;
      stack.push_back({K_ATTN, r.f[F_OUT_ATTN], 0, 1, ""});
    } else {
      return false;  // unknown op: caller falls back to Python
    }

    int op = r.f[F_OPCODE];
    r.sup = (src >= 0 && pos != 0 && SupervisedOp(op)) ? 1 : 0;
    // scratch sentinels for unused outputs
    if (!ProducesVec(op)) r.f[F_OUT_VEC] = SCRATCH;
    if (!ProducesFrames(op)) r.f[F_OUT_FRAMES] = SCRATCH;
    if (!ProducesAttn(op)) r.f[F_OUT_ATTN] = SCRATCH;
    bool attn_b = (op == TEMPORAL) ||
                  (op == LOCALIZE && r.f[F_COUNT] == 2);
    if (!attn_b) r.f[F_OUT_ATTN_B] = SCRATCH;
    rows.push_back(r);
  }

  if (stack.size() != 1) return false;
  const Val& root = stack[0];
  if (root.kind == K_KW) return false;
  if (static_cast<int>(rows.size()) > cap_steps) return false;

  for (size_t i = 0; i < rows.size(); ++i) {
    std::memcpy(fields + i * NFIELDS, rows[i].f, sizeof(int32_t) * NFIELDS);
    supervised[i] = rows[i].sup;
  }
  meta->steps = static_cast<int>(rows.size());
  meta->num_vec = nv;
  meta->num_frames = nf;
  meta->num_attn = na;
  meta->root_reg = root.r0;
  meta->root_is_vec = (root.kind == K_VEC) ? 1 : 0;
  return true;
}

bool ParseLowerOne(const char* program, const char* question, int cap_steps,
                   int32_t* fields, uint8_t* supervised, int32_t* meta_out,
                   bool aux_missing) {
  std::vector<std::string> tokens;
  if (!Tokenize(program, &tokens)) return false;
  std::vector<Cell> prog;
  prog.reserve(tokens.size());
  for (size_t i = 0; i < tokens.size(); ++i)
    prog.push_back({tokens[i], static_cast<int>(i)});

  std::vector<int> marks;
  if (!LinearRewrites(&prog, &marks)) return false;
  if (!marks.empty() && !RewriteIterate(&prog, marks)) return false;
  bool has_iu = false;
  for (auto& c : prog)
    if (c.tok == "IterateUntil") { has_iu = true; break; }
  if (has_iu && !RewriteIterateUntil(&prog)) return false;
  if (!prog.empty() && prog[0].tok == "Compare") {
    if (!RewriteCompare(&prog)) return false;
  }
  Meta meta;
  std::vector<std::string> norm_q;
  const std::vector<std::string>* nq = nullptr;
  if (question != nullptr) {
    norm_q = spanlink::NormalizeQuestion(question);
    nq = &norm_q;
  }
  if (!Lower(prog, cap_steps, fields, supervised, &meta, nq, aux_missing))
    return false;
  meta_out[0] = meta.steps;
  meta_out[1] = meta.num_vec;
  meta_out[2] = meta.num_frames;
  meta_out[3] = meta.num_attn;
  meta_out[4] = meta.root_reg;
  meta_out[5] = meta.root_is_vec;
  return true;
}

}  // namespace

extern "C" {

// Parse+lower a batch of programs (concatenated, NUL-separated). Inputs:
//   questions/q_offsets: optional (both null = no span linking) question
//     text per program; free-text args get lemma-matched token spans
//     (utils/agqa_lite.py:62-119 semantics via the text.py fallback rules).
//   aux_missing: unmatched spans lower to -2 (aux-embedding substitution)
//     instead of -1 (whole-question mean).
// Outputs:
//   fields     [B, cap_steps, 17] int32 (rows beyond steps untouched)
//   supervised [B, cap_steps] uint8
//   meta       [B, 6] int32: steps, num_vec, num_frames, num_attn,
//                            root_reg, root_is_vec
//   ok         [B] uint8 (0 = caller must fall back to the Python path)
void stair_parse_lower_batch(const char* programs, const int64_t* offsets,
                             const char* questions, const int64_t* q_offsets,
                             int64_t batch, int32_t cap_steps,
                             int32_t aux_missing,
                             int32_t* fields, uint8_t* supervised,
                             int32_t* meta, uint8_t* ok, int threads) {
  auto work = [&](int64_t b) {
    const char* q = (questions != nullptr && q_offsets != nullptr)
                        ? questions + q_offsets[b] : nullptr;
    ok[b] = ParseLowerOne(
        programs + offsets[b], q, cap_steps,
        fields + b * cap_steps * NFIELDS,
        supervised + b * cap_steps,
        meta + b * 6, aux_missing != 0) ? 1 : 0;
  };
  if (threads <= 1 || batch < 4) {
    for (int64_t b = 0; b < batch; ++b) work(b);
    return;
  }
  std::vector<std::thread> pool;
  std::atomic<int64_t>* next = new std::atomic<int64_t>(0);
  int workers = std::min<int64_t>(threads, batch);
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([&, next] {
      for (;;) {
        int64_t b = next->fetch_add(1);
        if (b >= batch) return;
        work(b);
      }
    });
  }
  for (auto& t : pool) t.join();
  delete next;
}

int stair_parser_version() { return 3; }

}  // extern "C"
