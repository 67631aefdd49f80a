// Single-CPU-core reference-class baseline for bench.py.
//
// Implements the CBL method's hot path the way the reference does on CPU
// (K=25): streaming necklace computation with a monotone deque of M-bit
// lexicographic minimizers (amortised O(1) per k-mer — the algorithm of the
// CBL paper; cf. /root/reference/src/necklace/queue.rs for the behavior it
// must match) and set storage in a flat open-addressing hash table, which is
// *faster* than the reference's rank/tiered/trie structure for pure
// throughput — i.e. this is a conservative (strong) baseline to compare the
// device path against.
//
// Input: a binary file of 2-bit base codes (uint8 per base).
// Output: one JSON line with single-core insert/query k-mers per second.
//
// Built on first use by bench.py (build_baseline) into bench/build/.

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <vector>

static constexpr int K = 25;
static constexpr int BITS = 2 * K;        // 50
static constexpr int M = 9;               // minimizer width (reference M=9)
static constexpr int WIDTH = BITS - M + 1; // 42 window positions
static constexpr int POS_BITS = 6;        // ceil(lg 64) for 50-bit words
static constexpr uint64_t MASK = (1ULL << BITS) - 1;
static constexpr uint64_t MIN_MASK = (1ULL << M) - 1;

// --- flat open-addressing hash set (linear probing, pow2 capacity) ---
// slot values: 0 = empty, 1 = tombstone (erased), else key+2
struct HashSet {
  std::vector<uint64_t> slots;
  size_t mask;
  size_t count = 0;
  explicit HashSet(size_t cap_pow2) : slots(cap_pow2, 0), mask(cap_pow2 - 1) {}
  static inline uint64_t hash(uint64_t x) {
    x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33; return x;
  }
  inline bool insert(uint64_t key) {
    uint64_t v = key + 2;
    size_t i = hash(key) & mask;
    size_t first_tomb = SIZE_MAX;
    while (true) {
      uint64_t s = slots[i];
      if (s == 0) {
        slots[first_tomb != SIZE_MAX ? first_tomb : i] = v;
        count++;
        return true;
      }
      if (s == 1 && first_tomb == SIZE_MAX) first_tomb = i;
      if (s == v) return false;
      i = (i + 1) & mask;
    }
  }
  inline bool contains(uint64_t key) const {
    uint64_t v = key + 2;
    size_t i = hash(key) & mask;
    while (true) {
      uint64_t s = slots[i];
      if (s == 0) return false;
      if (s == v) return true;
      i = (i + 1) & mask;
    }
  }
  inline bool erase(uint64_t key) {
    uint64_t v = key + 2;
    size_t i = hash(key) & mask;
    while (true) {
      uint64_t s = slots[i];
      if (s == 0) return false;
      if (s == v) { slots[i] = 1; count--; return true; }
      i = (i + 1) & mask;
    }
  }
};

// --- streaming necklace: monotone minimizer deque over the 42 window
// positions + the 8 wrap-around rotations ---
struct NecklaceStream {
  uint64_t word = 0;
  // (minimizer value, absolute position counter)
  std::deque<std::pair<uint64_t, uint64_t>> deq;
  uint64_t abs_pos = 0;  // absolute index of the next window to insert

  inline void push_window(uint64_t value) {
    // evict expired front (window left the 42-wide range)
    if (!deq.empty() && deq.front().second + WIDTH <= abs_pos)
      deq.pop_front();
    while (!deq.empty() && deq.back().first > value) deq.pop_back();
    deq.emplace_back(value, abs_pos);
    abs_pos++;
  }

  inline void seed(uint64_t w) {
    word = w & MASK;
    deq.clear();
    abs_pos = 0;
    for (int p = 0; p < WIDTH; p++)
      push_window((w >> (BITS - p - M)) & MIN_MASK);
  }

  inline void append_base(uint64_t b) {
    word = ((word << 2) | (b & 3)) & MASK;
    push_window((word >> 1) & MIN_MASK);
    push_window(word & MIN_MASK);
  }

  inline uint64_t rotation(int p) const {
    return ((word << p) & MASK) | (word >> (BITS - p));
  }

  // (necklace << POS_BITS) | pos, smallest pos among minima
  inline uint64_t packed_word() const {
    uint64_t best = ~0ULL;
    int best_pos = 0;
    // all deque entries tied at the minimum are candidate start positions
    uint64_t minval = deq.front().first;
    for (const auto& e : deq) {
      if (e.first != minval) break;
      int p = (int)(e.second - (abs_pos - WIDTH));  // window offset in [0,WIDTH)
      uint64_t rot = rotation(p);
      if (rot < best || (rot == best && p < best_pos)) { best = rot; best_pos = p; }
    }
    for (int p = WIDTH; p < BITS; p++) {  // wrap-around candidates
      uint64_t rot = rotation(p);
      if (rot < best || (rot == best && p < best_pos)) { best = rot; best_pos = p; }
    }
    return (best << POS_BITS) | (uint64_t)best_pos;
  }
};

// process [base, base+len) as one record: necklace-stream + op per k-mer
template <typename F>
static inline void for_each_packed(const uint8_t* codes, size_t len, F&& op) {
  if (len < (size_t)K) return;
  NecklaceStream ns;
  uint64_t w = 0;
  for (int i = 0; i < K; i++) w = (w << 2) | codes[i];
  ns.seed(w);
  op(ns.packed_word());
  for (size_t i = K; i < len; i++) {
    ns.append_base(codes[i]);
    op(ns.packed_word());
  }
}

// Interleaved dynamic workload (BASELINE config 2): the stream is split in
// SEGS segments (each its own record); per round: insert segment i, query
// segment max(i-1,0), remove the first half of segment i.  Must match
// bench.py --mode dynamic exactly (counts are cross-checked).
static int run_dynamic(const std::vector<uint8_t>& codes) {
  static constexpr int SEGS = 8;
  size_t sb = codes.size() / SEGS;
  size_t cap = 1;
  while (cap < codes.size() * 2) cap <<= 1;
  HashSet set(cap);
  size_t ops = 0, positive = 0;
  using clk = std::chrono::steady_clock;
  auto t0 = clk::now();
  for (int i = 0; i < SEGS; i++) {
    const uint8_t* seg = codes.data() + i * sb;
    for_each_packed(seg, sb, [&](uint64_t wd) { set.insert(wd); ops++; });
    const uint8_t* q = codes.data() + (i ? (i - 1) * sb : 0);
    for_each_packed(q, sb, [&](uint64_t wd) { positive += set.contains(wd); ops++; });
    for_each_packed(seg, sb / 2, [&](uint64_t wd) { set.erase(wd); ops++; });
  }
  auto t1 = clk::now();
  double t = std::chrono::duration<double>(t1 - t0).count();
  printf(
      "{\"mode\": \"dynamic\", \"ops\": %zu, \"distinct\": %zu, "
      "\"positive\": %zu, \"total_s\": %.6f, \"ops_per_s\": %.1f}\n",
      ops, set.count, positive, t, ops / t);
  return 0;
}

// Canonical-mode oracle + baseline (bench.py --canonical).  Key = the
// smaller of (k-mer, reverse-complement): any deterministic class
// representative yields the same distinct/positive counts as the
// device path's parity-canonical necklace words (one word per {x, rc(x)}
// class; cf. /root/reference/src/kmer.rs:93-106).  No necklace work at
// all, so as a TIMING baseline it is strictly stronger (faster) than a
// reference-class canonical implementation — the ratio is conservative.
static inline uint64_t canon_roll(uint64_t& w, uint64_t& rc, uint8_t b) {
  // encoding A/C/T/G = 00/01/10/11: complement = XOR 0b10
  w = ((w << 2) | (uint64_t)(b & 3)) & MASK;
  rc = (rc >> 2) | ((uint64_t)((b ^ 2) & 3) << (BITS - 2));
  return w < rc ? w : rc;
}

template <typename F>
static inline void for_each_canonical(const uint8_t* codes, size_t len,
                                      F&& op) {
  if (len < (size_t)K) return;
  uint64_t w = 0, rc = 0;
  for (int i = 0; i < K - 1; i++) canon_roll(w, rc, codes[i]);
  for (size_t i = K - 1; i < len; i++) op(canon_roll(w, rc, codes[i]));
}

static int run_canonical(const std::vector<uint8_t>& codes) {
  size_t n_kmers = codes.size() - K + 1;
  size_t cap = 1;
  while (cap < n_kmers * 2) cap <<= 1;
  HashSet set(cap);
  using clk = std::chrono::steady_clock;
  auto t0 = clk::now();
  for_each_canonical(codes.data(), codes.size(),
                     [&](uint64_t key) { set.insert(key); });
  auto t1 = clk::now();
  size_t positive = 0;
  for_each_canonical(codes.data(), codes.size(),
                     [&](uint64_t key) { positive += set.contains(key); });
  auto t2 = clk::now();
  double ti = std::chrono::duration<double>(t1 - t0).count();
  double tq = std::chrono::duration<double>(t2 - t1).count();
  printf(
      "{\"mode\": \"canonical\", \"n_kmers\": %zu, \"distinct\": %zu, "
      "\"positive\": %zu, \"insert_s\": %.6f, \"query_s\": %.6f}\n",
      n_kmers, set.count, positive, ti, tq);
  return 0;
}

static std::vector<int64_t> read_offsets(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) { fprintf(stderr, "cannot open %s\n", path); exit(2); }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<int64_t> off(n / 8);
  if (fread(off.data(), 8, off.size(), f) != off.size()) exit(2);
  fclose(f);
  return off;
}

// Multi-record build + separate multi-record query stream (bench.py
// --corpus genome: repeat-rich records, ~50% query hit rate) — the
// record-stream loop of the reference CLI, /root/reference/examples/cbl.rs
// :143-167 / :202-229, on the same flat hash set as the static mode.
static int run_records(const std::vector<uint8_t>& codes,
                       const std::vector<int64_t>& off,
                       const std::vector<uint8_t>& qcodes,
                       const std::vector<int64_t>& qoff,
                       bool canonical) {
  size_t nk_i = 0, nk_q = 0;
  for (size_t r = 0; r + 1 < off.size(); r++) {
    int64_t len = off[r + 1] - off[r];
    if (len >= K) nk_i += (size_t)(len - K + 1);
  }
  for (size_t r = 0; r + 1 < qoff.size(); r++) {
    int64_t len = qoff[r + 1] - qoff[r];
    if (len >= K) nk_q += (size_t)(len - K + 1);
  }
  size_t cap = 1;
  while (cap < nk_i * 2 + 2) cap <<= 1;
  HashSet set(cap);
  using clk = std::chrono::steady_clock;
  auto t0 = clk::now();
  for (size_t r = 0; r + 1 < off.size(); r++) {
    const uint8_t* p = codes.data() + off[r];
    size_t len = (size_t)(off[r + 1] - off[r]);
    if (canonical)
      for_each_canonical(p, len, [&](uint64_t wd) { set.insert(wd); });
    else
      for_each_packed(p, len, [&](uint64_t wd) { set.insert(wd); });
  }
  auto t1 = clk::now();
  size_t positive = 0;
  for (size_t r = 0; r + 1 < qoff.size(); r++) {
    const uint8_t* p = qcodes.data() + qoff[r];
    size_t len = (size_t)(qoff[r + 1] - qoff[r]);
    if (canonical)
      for_each_canonical(p, len,
                         [&](uint64_t wd) { positive += set.contains(wd); });
    else
      for_each_packed(p, len,
                      [&](uint64_t wd) { positive += set.contains(wd); });
  }
  auto t2 = clk::now();
  double ti = std::chrono::duration<double>(t1 - t0).count();
  double tq = std::chrono::duration<double>(t2 - t1).count();
  printf(
      "{\"mode\": \"records\", \"n_kmers_insert\": %zu, \"n_kmers_query\": "
      "%zu, \"distinct\": %zu, \"positive\": %zu, \"insert_s\": %.6f, "
      "\"query_s\": %.6f}\n",
      nk_i, nk_q, set.count, positive, ti, tq);
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 2) { fprintf(stderr, "usage: baseline <codes.bin> [dynamic | records <off.bin> <qcodes.bin> <qoff.bin>]\n"); return 2; }
  FILE* f = fopen(argv[1], "rb");
  if (!f) { fprintf(stderr, "cannot open %s\n", argv[1]); return 2; }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> codes(n);
  if (fread(codes.data(), 1, n, f) != (size_t)n) { return 2; }
  fclose(f);
  if (n < K) { fprintf(stderr, "input too short\n"); return 2; }
  if (argc > 2 && strcmp(argv[2], "dynamic") == 0) return run_dynamic(codes);
  if (argc > 2 && strcmp(argv[2], "canonical") == 0) return run_canonical(codes);
  if (argc > 5 && strcmp(argv[2], "records") == 0) {
    std::vector<int64_t> off = read_offsets(argv[3]);
    FILE* qf = fopen(argv[4], "rb");
    if (!qf) { fprintf(stderr, "cannot open %s\n", argv[4]); return 2; }
    fseek(qf, 0, SEEK_END);
    long qn = ftell(qf);
    fseek(qf, 0, SEEK_SET);
    std::vector<uint8_t> qcodes(qn);
    if (fread(qcodes.data(), 1, qn, qf) != (size_t)qn) return 2;
    fclose(qf);
    std::vector<int64_t> qoff = read_offsets(argv[5]);
    bool canon = argc > 6 && strcmp(argv[6], "canonical") == 0;
    return run_records(codes, off, qcodes, qoff, canon);
  }
  size_t n_kmers = n - K + 1;

  size_t cap = 1;
  while (cap < n_kmers * 2) cap <<= 1;
  HashSet set(cap);

  using clk = std::chrono::steady_clock;

  // --- insert pass ---
  auto t0 = clk::now();
  {
    NecklaceStream ns;
    uint64_t w = 0;
    for (int i = 0; i < K; i++) w = (w << 2) | codes[i];
    ns.seed(w);
    set.insert(ns.packed_word());
    for (size_t i = K; i < (size_t)n; i++) {
      ns.append_base(codes[i]);
      set.insert(ns.packed_word());
    }
  }
  auto t1 = clk::now();

  // --- query pass ---
  size_t positive = 0;
  {
    NecklaceStream ns;
    uint64_t w = 0;
    for (int i = 0; i < K; i++) w = (w << 2) | codes[i];
    ns.seed(w);
    positive += set.contains(ns.packed_word());
    for (size_t i = K; i < (size_t)n; i++) {
      ns.append_base(codes[i]);
      positive += set.contains(ns.packed_word());
    }
  }
  auto t2 = clk::now();

  double ti = std::chrono::duration<double>(t1 - t0).count();
  double tq = std::chrono::duration<double>(t2 - t1).count();
  printf(
      "{\"n_kmers\": %zu, \"distinct\": %zu, \"positive\": %zu, "
      "\"insert_s\": %.6f, \"query_s\": %.6f, "
      "\"insert_kmers_per_s\": %.1f, \"query_kmers_per_s\": %.1f}\n",
      n_kmers, set.count, positive, ti, tq, n_kmers / ti, n_kmers / tq);
  return 0;
}
