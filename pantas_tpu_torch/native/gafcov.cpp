// Native GAF coverage engine: parse + walk-distribution + scatter-add.
//
// The hot loop of the augment stage (behavioral contract:
// scripts/alignments_augmentation_from_gaf.py of the reference, exactly as
// re-specified in pantas_tpu_torch/coverage/semantics.py). Python streams are
// ~50k reads/s; this engine parses the GAF and accumulates the flat counts
// vector (layout [NC | IL | OL | RC], see graph/compiler.py) at memory
// speed. First-seen orders (IL/OL offsets, novel edges) are recorded so
// emission stays byte-identical to the reference augmenter.
//
// C API (ctypes): gafcov_create / gafcov_process_file / accessors /
// gafcov_destroy.

#include <cctype>
#include <cstdint>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// CLOCK_MONOTONIC nanoseconds: Python's time.perf_counter_ns() on Linux, so
// the stamps below line up with the port's spans (pantas_tpu_torch/trace.py)
inline int64_t mono_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

struct Cig {
  char op;
  int64_t len;
};

struct Engine {
  int64_t n_nodes = 0;
  const int64_t *ids = nullptr;       // sorted node ids (int64), size n_nodes
  const int32_t *node_len = nullptr;  // aligned with ids order? NO: aligned with node index
  const uint64_t *edge_key = nullptr; // sorted packed (src_idx<<32)|dst_idx
  int64_t n_edges = 0;
  const int64_t *il_base = nullptr;   // per node index
  const int64_t *ol_base = nullptr;
  int64_t rc_base = 0;
  int64_t total_slots = 0;
  bool dense_ids = false;             // ids are exactly 1..n_nodes

  std::vector<int32_t> counts;        // flat counts vector
  std::vector<int64_t> seen_order;    // IL/OL slots in first-seen order
  // (no separate seen-flag array: hist slots are touched only by
  //  bump_hist, so counts[slot]==0 IS the never-seen predicate)

  // slot-stream mode (the TPU device-engine feed): instead of accumulating
  // host-side, every count contribution is appended to slot_stream as a
  // flat int32 slot index; the device scatter-adds the stream and the final
  // counts are copied back via gafcov_counts_set before emission. The
  // session's master engine keeps the first-seen flags for hist slots in
  // counts[], which the pieces of its waves read (wave_seen). seen_pos /
  // novel_pos record the byte offset of each first sighting so multi-
  // process shards can reconstruct the global file order (the contract of
  // parallel/distributed.py::_merge_sidecars).
  bool collect_slots = false;
  std::vector<int32_t> slot_stream;
  std::vector<int64_t> seen_pos;      // aligned with seen_order
  std::unordered_map<uint64_t, int64_t> novel_pos;
  int64_t cur_pos = -1;               // byte offset of the current record
  // a piece of a parallel wave of the slot session (gafcov_slots_next): the
  // master's seen flags, only read while the wave runs; seen_bits filters
  // this piece's own first sightings, which the master takes in piece order
  const int32_t *wave_seen = nullptr;

  // CSR over the sorted edge table: edge_key's (src<<32|dst) sort order IS
  // grouped-by-src order, so csr_off[src]..csr_off[src+1] indexes the slot
  // range of src's out-edges — O(out-degree) lookup, 2 cache lines, instead
  // of a 17-level binary search over the whole table
  std::vector<int64_t> csr_off;       // size n_nodes+1
  const int64_t *csr = nullptr;       // csr_off's data, or a master's (clones)

  std::unordered_map<uint64_t, int32_t> novel;  // packed idx pair -> count
  std::vector<uint64_t> novel_order;

  int64_t rejected = 0, skipped = 0, accepted = 0;

  // the last emission's phases and sizes (gafcov_emit_stats)
  int64_t emit_stats[13] = {0};

  // scratch
  std::vector<Cig> cig;
  std::vector<int32_t> walk;       // node indices
  std::vector<int32_t> aln_node;   // per aligned node: node index
  std::vector<int32_t> aln_off;    // start offset into ops arrays
  std::vector<Cig> aln_ops;        // concatenated per-node op lists
  std::vector<int32_t> keep_node;  // cleaned node indices
  std::vector<int32_t> keep_off;
  std::vector<int32_t> keep_cnt;
  std::vector<Cig> keep_ops;

  int64_t node_index(int64_t id) const {
    if (dense_ids) {
      if (id >= 1 && id <= n_nodes) return id - 1;
      return -1;
    }
    int64_t lo = 0, hi = n_nodes;
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (ids[mid] < id) lo = mid + 1;
      else hi = mid;
    }
    if (lo < n_nodes && ids[lo] == id) return lo;
    return -1;
  }

  int64_t edge_slot(uint64_t key) const {
    int64_t src = (int64_t)(key >> 32);
    for (int64_t i = csr[src], e = csr[src + 1]; i < e; ++i)
      if (edge_key[i] == key) return i;
    return -1;
  }

  void build_csr() {
    csr_off.assign(n_nodes + 1, 0);
    for (int64_t i = 0; i < n_edges; ++i)
      csr_off[(edge_key[i] >> 32) + 1]++;
    for (int64_t i = 0; i < n_nodes; ++i) csr_off[i + 1] += csr_off[i];
    csr = csr_off.data();
  }

  // --- binned accumulation (large-graph stats mode) -----------------------
  // At genome scale the counts vector is ~1 GB, so counts[slot]++ is a DRAM
  // miss per bump (measured 2.6M -> 201k reads/s panel -> genome,
  // docs/PERFORMANCE.md "Augment at whole-genome scale"). Buffering slot
  // indices into per-range bins and draining each full bin as a burst keeps
  // every drained increment inside one L2-sized counts window — the host
  // mirror of the sorted-run device kernel's insight (sort fixes the access
  // pattern). First-seen tracking moves to a bitset (8x denser than counts,
  // and the deferred counts can no longer serve as the predicate).
  static constexpr int BIN_SHIFT = 18;  // 256K slots = 1 MB counts window
  static constexpr int BIN_CAP = 4096;  // buffered entries per bin (16 KB)
  bool binned = false;
  std::vector<int32_t> bin_buf;   // n_bins x BIN_CAP, flat
  std::vector<int32_t> bin_n;     // per-bin fill
  std::vector<uint64_t> seen_bits;
  // shared-counts mode (MT shards): drains target the MASTER's counts
  // vector under a per-bin lock instead of a private dense copy — at
  // genome scale a per-shard counts vector costs ~1 GB of allocation +
  // zeroing + a dense 236M-add merge per shard, which dwarfs the ~23M
  // real increments of a 1M-read stream (measured: threads=2 was 4x
  // SLOWER than threads=1 before this). Bins make the lock coarse
  // (one acquisition per 4096 increments) and drains of one bin touch
  // one disjoint counts window.
  int32_t *shared_counts = nullptr;
  std::mutex *bin_locks = nullptr;  // owned by the master

  void enable_bins() {
    binned = true;
    size_t n_bins = (size_t)((total_slots >> BIN_SHIFT) + 1);
    bin_buf.resize(n_bins * (size_t)BIN_CAP);
    bin_n.assign(n_bins, 0);
    seen_bits.assign((size_t)(total_slots + 63) / 64, 0);
    if (!bin_locks_own) bin_locks_own.reset(new std::mutex[n_bins]);
  }
  std::unique_ptr<std::mutex[]> bin_locks_own;

  // true exactly once per slot, in call order (stream first-seen order)
  bool seen_mark(int64_t slot) {
    uint64_t &w = seen_bits[(uint64_t)slot >> 6];
    uint64_t m = 1ull << (slot & 63);
    if (w & m) return false;
    w |= m;
    return true;
  }

  void drain_bin(size_t b, const int32_t *buf, int32_t n) {
    if (shared_counts) {
      std::lock_guard<std::mutex> g(bin_locks[b]);
      for (int32_t i = 0; i < n; ++i) shared_counts[buf[i]]++;
    } else {
      for (int32_t i = 0; i < n; ++i) counts[buf[i]]++;
    }
  }

  void bin_push(int64_t slot) {
    size_t b = (size_t)(slot >> BIN_SHIFT);
    int32_t *buf = bin_buf.data() + b * (size_t)BIN_CAP;
    int32_t n = bin_n[b];
    buf[n] = (int32_t)slot;
    if (++n == BIN_CAP) {
      drain_bin(b, buf, BIN_CAP);
      n = 0;
    }
    bin_n[b] = n;
  }

  void flush_bins() {
    if (!binned) return;
    for (size_t b = 0; b < bin_n.size(); ++b) {
      int32_t n = bin_n[b];
      if (!n) continue;
      drain_bin(b, bin_buf.data() + b * (size_t)BIN_CAP, n);
      bin_n[b] = 0;
    }
  }
  // ------------------------------------------------------------------------

  void bump(int64_t slot) {
    if (collect_slots) {
      slot_stream.push_back((int32_t)slot);
      return;
    }
    if (binned) {
      bin_push(slot);
      return;
    }
    counts[slot]++;
  }

  void bump_hist(int64_t slot) {
    if (collect_slots) {
      // a piece of a wave: a candidate first sighting, once a piece
      if (wave_seen[slot] == 0 && seen_mark(slot)) {
        seen_order.push_back(slot);
        seen_pos.push_back(cur_pos);
      }
      slot_stream.push_back((int32_t)slot);
      return;
    }
    if (binned) {
      if (seen_mark(slot)) seen_order.push_back(slot);
      bin_push(slot);
      return;
    }
    if (counts[slot]++ == 0) seen_order.push_back(slot);
  }
};

inline bool is_op(char c) {
  return c == '=' || c == ':' || c == '*' || c == '+' || c == '-' || c == '~';
}

inline bool is_dig(char c) { return (unsigned)(c - '0') <= 9u; }

// non-negative integer parse over [s, e); stops at the first non-digit —
// same result as strtoll on these fields (GAF numeric columns are unsigned)
inline int64_t parse_u(const char *s, const char *e) {
  int64_t v = 0;
  while (s < e && is_dig(*s)) v = v * 10 + (*s++ - '0');
  return v;
}

// cs tokenizer; contract identical to io/gaf.py::tokenize_cs
void tokenize_cs(const char *s, const char *end, std::vector<Cig> &out) {
  out.clear();
  char op = 0;
  const char *tok = s;
  auto close = [&](const char *tstart, const char *tend) {
    if (!op) return;
    if (op == '*') {
      out.push_back({'*', 1});
    } else {
      bool digits = tend > tstart;
      for (const char *p = tstart; p < tend; ++p)
        if (!is_dig(*p)) { digits = false; break; }
      if (digits)
        out.push_back({op, parse_u(tstart, tend)});
      else
        out.push_back({op, tend - tstart});
    }
    op = 0;
  };
  const char *p = s;
  while (p < end) {
    if (is_op(*p)) {
      close(tok, p);
      op = *p;
      tok = p + 1;
    }
    ++p;
  }
  close(tok, end);
}

struct Field {
  const char *s;
  const char *e;
  int64_t as_int() const { return parse_u(s, e); }
};

// process one GAF line; returns 0 ok
void process_line(Engine &E, const char *line, const char *lend, int mapq_thr,
                  double max_dv) {
  // split into tab/space fields like Python str.split()
  Field f[13];
  int nf = 0;
  const char *p = line;
  const char *tags_start = nullptr;
  while (p < lend && nf < 12) {
    while (p < lend && (*p == '\t' || *p == ' ')) ++p;
    if (p >= lend) break;
    const char *q = p;
    while (q < lend && *q != '\t' && *q != ' ') ++q;
    f[nf].s = p;
    f[nf].e = q;
    ++nf;
    p = q;
  }
  if (nf < 12) return;  // malformed; reference would crash
  while (p < lend && (*p == '\t' || *p == ' ')) ++p;
  tags_start = p;

  int64_t mapq = f[11].as_int();
  if (mapq < mapq_thr) {
    E.rejected++;
    return;
  }
  if (f[5].e - f[5].s == 1 && *f[5].s == '*') {
    E.skipped++;
    return;
  }

  int64_t path_len = f[6].as_int();
  int64_t start_pos = f[7].as_int();
  int64_t end_pos_rel = path_len - f[8].as_int();

  // find cs: substring in tags (to whitespace), dv:f: value
  const char *cs_s = nullptr, *cs_e = nullptr;
  double dv = -1.0;
  bool has_dv = false;
  for (const char *t = tags_start; t + 2 < lend; ++t) {
    if (cs_s && has_dv) break;  // first match wins for both (re.search)
    if (!cs_s && t[0] == 'c' && t[1] == 's' && t[2] == ':') {
      cs_s = t;
      const char *q = t;
      while (q < lend && *q != '\t' && *q != ' ') ++q;
      cs_e = q;
    }
    if (!has_dv && t + 4 < lend && t[0] == 'd' && t[1] == 'v' && t[2] == ':' &&
        t[3] == 'f' && t[4] == ':') {
      const char *q = t + 5;
      if (q < lend && is_dig(*q)) {
        // mirror the reference regex dv:f:(\d+(\.\d+)?) exactly: stop at
        // anything but digits and one dot (no exponent notation)
        const char *d = q;
        while (d < lend && isdigit((unsigned char)*d)) ++d;
        if (d < lend && *d == '.' && d + 1 < lend &&
            isdigit((unsigned char)d[1])) {
          ++d;
          while (d < lend && isdigit((unsigned char)*d)) ++d;
        }
        char tmp[64];
        size_t n = (size_t)(d - q) < sizeof(tmp) - 1 ? (size_t)(d - q)
                                                     : sizeof(tmp) - 1;
        memcpy(tmp, q, n);
        tmp[n] = 0;
        dv = strtod(tmp, nullptr);
        has_dv = true;
      }
    }
  }
  if (cs_s && cs_e - cs_s >= 5 && strncmp(cs_s, "cs:Z:", 5) == 0) cs_s += 5;

  E.cig.clear();
  // the reference strips EVERY 'cs:Z:' occurrence in the matched tag
  // (str.replace over the token, alignments_augmentation_from_gaf.py:158),
  // not just the prefix; interior hits are pathological, so the copy only
  // happens when one exists
  std::string cs_scratch;
  if (cs_s && (size_t)(cs_e - cs_s) >= 5 &&
      memmem(cs_s, cs_e - cs_s, "cs:Z:", 5) != nullptr) {
    cs_scratch.reserve(cs_e - cs_s);
    const char *q = cs_s;
    while (q < cs_e) {
      if (cs_e - q >= 5 && memcmp(q, "cs:Z:", 5) == 0) {
        q += 5;
      } else {
        cs_scratch += *q++;
      }
    }
    cs_s = cs_scratch.data();
    cs_e = cs_s + cs_scratch.size();
  }
  if (cs_s)
    tokenize_cs(cs_s, cs_e, E.cig);
  else {
    const char star[] = "*";
    tokenize_cs(star, star + 1, E.cig);
  }

  // 2-op clipping
  if (E.cig.size() == 2) {
    if (E.cig[0].op == '+' && E.cig[1].op == ':') {
      start_pos += E.cig[0].len;
      E.cig[0] = E.cig[1];
      E.cig.pop_back();
    } else if (E.cig[0].op == ':' && E.cig[1].op == '+') {
      E.cig.pop_back();
    }
  }

  if (has_dv && dv > max_dv) {
    E.skipped++;
    return;
  }

  // walk parse with consecutive-duplicate dedupe
  bool rev = *f[5].s == '<';
  char sep = rev ? '<' : '>';
  E.walk.clear();
  {
    const char *q = f[5].s;
    int64_t last_id = -1;
    while (q < f[5].e) {
      if (*q == sep) {
        ++q;
        const char *ns = q;
        while (q < f[5].e && *q != '<' && *q != '>') ++q;
        int64_t id = parse_u(ns, q);
        if (E.walk.empty() || id != last_id) {
          int64_t ni = E.node_index(id);
          // unknown node: mirror reference KeyError by skipping line hard
          if (ni < 0) return;
          E.walk.push_back((int32_t)ni);
          last_id = id;
        }
      } else {
        ++q;
      }
    }
  }
  if (E.walk.empty()) return;

  E.accepted++;

  // distribute ops over node spans
  E.aln_node.clear();
  E.aln_off.clear();
  E.aln_ops.clear();
  size_t ci = 0;  // index into E.cig; consume destructively via remaining len
  int64_t cur_remaining = ci < E.cig.size() ? E.cig[ci].len : 0;
  size_t n_nodes_walk = E.walk.size();
  bool out_of_ops = false;
  for (size_t i = 0; i < n_nodes_walk && !out_of_ops; ++i) {
    int32_t ni = E.walk[i];
    int64_t span = E.node_len[ni];
    if (i == 0) span -= start_pos;
    if (i == n_nodes_walk - 1) span -= end_pos_rel - 1;
    bool first = true;
    while (span > 0) {
      if (ci >= E.cig.size()) {
        out_of_ops = true;
        break;
      }
      char op = E.cig[ci].op;
      int64_t ln = cur_remaining;
      int64_t take;
      if (span <= ln) {
        take = span;
        cur_remaining = ln - span;
        span = 0;
        if (cur_remaining == 0) {
          ++ci;
          cur_remaining = ci < E.cig.size() ? E.cig[ci].len : 0;
        }
      } else {
        take = ln;
        span -= ln;
        ++ci;
        cur_remaining = ci < E.cig.size() ? E.cig[ci].len : 0;
      }
      if (first) {
        E.aln_node.push_back(ni);
        E.aln_off.push_back((int32_t)E.aln_ops.size());
        first = false;
      }
      E.aln_ops.push_back({op, take});
    }
  }
  E.aln_off.push_back((int32_t)E.aln_ops.size());

  // clean + compact into keep_*
  E.keep_node.clear();
  E.keep_off.clear();
  E.keep_cnt.clear();
  E.keep_ops.clear();
  for (size_t i = 0; i < E.aln_node.size(); ++i) {
    int32_t o0 = E.aln_off[i], o1 = E.aln_off[i + 1];
    if (o1 - o0 == 1 && (E.aln_ops[o0].op == '-' || E.aln_ops[o0].op == '+'))
      continue;  // pure single indel node drops
    int32_t start = (int32_t)E.keep_ops.size();
    for (int32_t j = o0; j < o1; ++j) {
      Cig a = E.aln_ops[j];
      if (j == o0) {
        if (a.op == '*') continue;  // leading substitution merges below
        E.keep_ops.push_back(a);
      } else if ((int32_t)E.keep_ops.size() == start) {
        E.keep_ops.push_back({a.op, a.len + 1});
      } else if (a.op == E.keep_ops.back().op || a.op == '*') {
        E.keep_ops.back().len += a.len;
      } else {
        E.keep_ops.push_back(a);
      }
    }
    E.keep_node.push_back(E.aln_node[i]);
    E.keep_off.push_back(start);
    E.keep_cnt.push_back((int32_t)E.keep_ops.size() - start);
  }

  size_t K = E.keep_node.size();
  for (size_t i = 0; i < K; ++i) E.bump(E.keep_node[i]);  // NC slots == index

  // IL/OL per compacted op
  for (size_t i = 0; i < K; ++i) {
    int32_t ni = E.keep_node[i];
    int64_t len = E.node_len[ni];
    int32_t o0 = E.keep_off[i], cnt = E.keep_cnt[i];
    bool fst = i == 0, lst = i == K - 1;
    for (int32_t j = 0; j < cnt; ++j) {
      Cig c = E.keep_ops[o0 + j];
      // slot = base + offset + 1: offsets span -1..len (a full-node
      // deletion compacts to OL offset -1 in the reference semantics)
      if (c.op == '-') {
        if (!rev) {
          if (!fst && j == 0) E.bump_hist(E.il_base[ni] + c.len + 1);
          if (!lst && j == cnt - 1) E.bump_hist(E.ol_base[ni] + len - c.len);
        } else {
          if (!fst && j == 0) E.bump_hist(E.ol_base[ni] + len - c.len);
          if (!lst && j == cnt - 1) E.bump_hist(E.il_base[ni] + c.len + 1);
        }
      } else if (c.op != '*') {
        if (!rev) {
          if (!fst) E.bump_hist(E.il_base[ni] + 1);
          if (!lst) E.bump_hist(E.ol_base[ni] + len + 1);
        } else {
          if (!lst) E.bump_hist(E.il_base[ni] + 1);
          if (!fst) E.bump_hist(E.ol_base[ni] + len + 1);
        }
      }
    }
  }

  // edges
  for (size_t i = 0; i + 1 < K; ++i) {
    uint64_t a = (uint64_t)E.keep_node[i], b = (uint64_t)E.keep_node[i + 1];
    if (rev) { uint64_t t = a; a = b; b = t; }
    uint64_t key = (a << 32) | b;
    int64_t slot = E.edge_slot(key);
    if (slot >= 0) {
      E.bump(E.rc_base + slot);
    } else {
      auto it = E.novel.find(key);
      if (it == E.novel.end()) {
        E.novel.emplace(key, 1);
        E.novel_order.push_back(key);
        if (E.collect_slots) E.novel_pos.emplace(key, E.cur_pos);
      } else {
        it->second++;
      }
    }
  }
}

// the next line start at or after guess (end if none): where a range is cut
// for threads
inline const char *line_cut(const char *guess, const char *end) {
  if (guess >= end) return end;
  const char *nl = (const char *)memchr(guess, '\n', end - guess);
  return nl ? nl + 1 : end;
}

// process every line in [begin, end) of the mapping at data (cur_pos is a
// line's offset in it); returns the records (non-blank lines)
int64_t process_range(Engine &E, const char *data, const char *begin,
                      const char *end, int mapq_thr, double max_dv) {
  int64_t lines = 0;
  const char *p = begin;
  while (p < end) {
    const char *nl = (const char *)memchr(p, '\n', end - p);
    const char *le = nl ? nl : end;
    const char *ls = p;
    E.cur_pos = ls - data;
    while (le > ls && (le[-1] == '\r' || le[-1] == ' ')) --le;
    if (le > ls) {
      process_line(E, ls, le, mapq_thr, max_dv);
      ++lines;
    }
    p = nl ? nl + 1 : end;
  }
  E.flush_bins();  // drain inside the worker thread (parallel)
  return lines;
}

// a new engine on E's graph tables, which it shares and only reads
Engine *clone_tables(const Engine &E) {
  Engine *c = new Engine();
  c->n_nodes = E.n_nodes;
  c->ids = E.ids;
  c->node_len = E.node_len;
  c->edge_key = E.edge_key;
  c->n_edges = E.n_edges;
  c->il_base = E.il_base;
  c->ol_base = E.ol_base;
  c->rc_base = E.rc_base;
  c->total_slots = E.total_slots;
  c->dense_ids = E.dense_ids;
  c->csr = E.csr;
  return c;
}

Engine *clone_config(const Engine &E) {
  Engine *c = clone_tables(E);
  if (E.binned) {
    // shared-counts shard: private bins + seen bitset, drains into the
    // master's counts under its per-bin locks — no 1 GB private copy
    c->enable_bins();
    c->shared_counts = const_cast<int32_t *>(E.counts.data());
    c->bin_locks = E.bin_locks_own.get();
  } else {
    c->counts.assign(E.total_slots, 0);
  }
  return c;
}

// merge a shard into main IN CHUNK ORDER, preserving global first-seen
// orders (a slot/edge first seen by chunk i precedes anything first seen by
// chunk i+1, and within-chunk order is the stream order) — this keeps the
// multi-threaded augmented-GFA emission byte-identical to a serial run.
void merge_shard(Engine &M, Engine &S) {
  M.flush_bins();
  S.flush_bins();
  // seen check must precede the count add (M.counts[slot]>0 == M saw it;
  // in binned mode the bitset carries the predicate instead — with
  // shared counts the adds already landed during the shard's drains)
  for (int64_t slot : S.seen_order) {
    bool unseen = M.binned ? M.seen_mark(slot) : M.counts[slot] == 0;
    if (unseen) M.seen_order.push_back(slot);
  }
  if (!S.shared_counts)
    for (int64_t i = 0; i < M.total_slots; ++i) M.counts[i] += S.counts[i];
  for (uint64_t key : S.novel_order) {
    auto it = M.novel.find(key);
    if (it == M.novel.end()) {
      M.novel.emplace(key, S.novel[key]);
      M.novel_order.push_back(key);
    } else {
      it->second += S.novel[key];
    }
  }
  M.rejected += S.rejected;
  M.skipped += S.skipped;
  M.accepted += S.accepted;
}

}  // namespace

extern "C" {

// multi-threaded file processing: mmap + line-aligned chunking, one private
// accumulator per thread, ordered merge (byte-identical emission preserved)
int64_t gafcov_process_file_mt(void *h, const char *path, int mapq_thr,
                               double max_dv, int n_threads) {
  Engine *E = (Engine *)h;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return st.st_size == 0 ? 0 : -1;
  }
  size_t size = st.st_size;
  char *data = (char *)mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (data == MAP_FAILED) return -1;
  // prefetch + batch the minor faults (165 MB at 4 KB/fault otherwise
  // serializes ~40k faults into the parse threads)
  madvise(data, size, MADV_SEQUENTIAL);
  madvise(data, size, MADV_WILLNEED);

  if (n_threads < 1) n_threads = 1;
  std::vector<const char *> cut(n_threads + 1);
  cut[0] = data;
  cut[n_threads] = data + size;
  for (int t = 1; t < n_threads; ++t)
    cut[t] = line_cut(data + (size * t) / n_threads, data + size);

  std::vector<Engine *> shards(n_threads);
  std::vector<int64_t> lines(n_threads, 0);
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) {
    shards[t] = clone_config(*E);
    threads.emplace_back([&, t]() {
      lines[t] = process_range(*shards[t], data, cut[t], cut[t + 1], mapq_thr, max_dv);
    });
  }
  int64_t total = 0;
  for (int t = 0; t < n_threads; ++t) {
    threads[t].join();
  }
  for (int t = 0; t < n_threads; ++t) {
    merge_shard(*E, *shards[t]);
    total += lines[t];
    delete shards[t];
  }
  munmap(data, size);
  return total;
}

void *gafcov_create(int64_t n_nodes, const int64_t *ids, const int32_t *node_len,
                    const uint64_t *edge_key, int64_t n_edges,
                    const int64_t *il_base, const int64_t *ol_base,
                    int64_t rc_base, int64_t total_slots, int dense_ids) {
  Engine *E = new Engine();
  E->n_nodes = n_nodes;
  E->ids = ids;
  E->node_len = node_len;
  E->edge_key = edge_key;
  E->n_edges = n_edges;
  E->il_base = il_base;
  E->ol_base = ol_base;
  E->rc_base = rc_base;
  E->total_slots = total_slots;
  E->dense_ids = dense_ids != 0;
  E->counts.assign(total_slots, 0);
  E->build_csr();
  // beyond ~8M slots (32 MB of counts) scattered increments start missing
  // cache; switch the stats mode to binned accumulation
  // (PANTAS_NO_BINS opts out — the measurement/debug escape hatch)
  if (total_slots >= ((int64_t)1 << 23) && !getenv("PANTAS_NO_BINS"))
    E->enable_bins();
  return E;
}

int64_t gafcov_process_file(void *h, const char *path, int mapq_thr,
                            double max_dv) {
  Engine *E = (Engine *)h;
  FILE *fp = fopen(path, "rb");
  if (!fp) return -1;
  // buffered line reader
  size_t cap = 1 << 22;
  char *buf = (char *)malloc(cap);
  size_t have = 0;
  int64_t lines = 0;
  for (;;) {
    size_t got = fread(buf + have, 1, cap - have, fp);
    have += got;
    if (have == 0) break;
    size_t start = 0;
    for (;;) {
      char *nl = (char *)memchr(buf + start, '\n', have - start);
      if (!nl) break;
      const char *ls = buf + start;
      const char *le = nl;
      while (le > ls && (*(le - 1) == '\r' || *(le - 1) == ' ')) --le;
      if (le > ls) {
        process_line(*E, ls, le, mapq_thr, max_dv);
        ++lines;
      }
      start = (nl - buf) + 1;
    }
    if (start == 0) {
      // line longer than buffer: grow
      if (got == 0) {  // EOF with partial line
        const char *ls = buf;
        const char *le = buf + have;
        while (le > ls && (*(le - 1) == '\r' || *(le - 1) == ' ')) --le;
        if (le > ls) {
          process_line(*E, ls, le, mapq_thr, max_dv);
          ++lines;
        }
        have = 0;
        break;
      }
      cap *= 2;
      buf = (char *)realloc(buf, cap);
      continue;
    }
    memmove(buf, buf + start, have - start);
    have -= start;
    if (got == 0) {
      if (have > 0) {
        const char *ls = buf;
        const char *le = buf + have;
        while (le > ls && (*(le - 1) == '\r' || *(le - 1) == ' ')) --le;
        if (le > ls) {
          process_line(*E, ls, le, mapq_thr, max_dv);
          ++lines;
        }
      }
      break;
    }
  }
  free(buf);
  fclose(fp);
  E->flush_bins();
  return lines;
}

const int32_t *gafcov_counts(void *h) {
  Engine *E = (Engine *)h;
  E->flush_bins();  // binned mode defers increments; drain before reading
  return E->counts.data();
}

int64_t gafcov_seen_count(void *h) { return ((Engine *)h)->seen_order.size(); }
const int64_t *gafcov_seen_order(void *h) {
  return ((Engine *)h)->seen_order.data();
}

int64_t gafcov_novel_count(void *h) { return ((Engine *)h)->novel_order.size(); }
void gafcov_novel_fill(void *h, uint64_t *keys, int32_t *vals) {
  Engine *E = (Engine *)h;
  for (size_t i = 0; i < E->novel_order.size(); ++i) {
    keys[i] = E->novel_order[i];
    vals[i] = E->novel[E->novel_order[i]];
  }
}

// --- augmented-GFA emission ------------------------------------------------
//
// Copy gfa_in appending NC/IL/OL to S lines and RC to L lines
// (byte-identical to the reference augmenter's output), then novel links in
// first-seen order. Parallel formatting: a GFA of 8 MiB or more splits into
// about four line-aligned chunks a thread (1 MiB at the least but the last),
// which the threads take from a shared worklist, each chunk formatted into a
// private buffer, buffers written in order — output bytes are identical to
// the serial walk. The one piece of sequential state is the reference's
// duplicate-L-line rule (only the FIRST occurrence of an edge prints its
// weight): edges are claimed with an atomic fetch-or, and if any edge is
// ever seen twice (never the case for well-formed GFAs) the whole emission
// falls back to a single-threaded pass where file order is claim order.

namespace {

// format one GFA line (plus tags) into `o`; returns false on a duplicate
// edge claim under multi-threading (caller falls back to serial)
inline bool emit_line(Engine *E, const char *ls, const char *le,
                      const std::vector<std::vector<int64_t>> &il_offs,
                      const std::vector<std::vector<int64_t>> &ol_offs,
                      uint8_t *claimed, bool atomic_claims, std::string &o) {
  char tag[256];
  if (le > ls && ls[0] == 'S') {
    const char *p = ls + 1;
    while (p < le && (*p == '\t' || *p == ' ')) ++p;
    int64_t id = strtoll(p, nullptr, 10);
    int64_t ni = E->node_index(id);
    o.append(ls, le - ls);
    int64_t nc = (ni >= 0) ? E->counts[ni] : 0;
    int n = snprintf(tag, sizeof tag, "\tNC:i:%lld", (long long)nc);
    o.append(tag, n);
    if (ni >= 0 && !il_offs[ni].empty()) {
      o.append("\tIL:Z:");
      bool first = true;
      for (int64_t off : il_offs[ni]) {
        n = snprintf(tag, sizeof tag, "%s%lld.%d", first ? "" : ",",
                     (long long)off, E->counts[E->il_base[ni] + off + 1]);
        o.append(tag, n);
        first = false;
      }
    }
    if (ni >= 0 && !ol_offs[ni].empty()) {
      o.append("\tOL:Z:");
      bool first = true;
      for (int64_t off : ol_offs[ni]) {
        n = snprintf(tag, sizeof tag, "%s%lld.%d", first ? "" : ",",
                     (long long)off, E->counts[E->ol_base[ni] + off + 1]);
        o.append(tag, n);
        first = false;
      }
    }
    o.push_back('\n');
  } else if (le > ls && ls[0] == 'L') {
    if (le - ls == 1) {
      // bare 'L' line is skipped by the reference
    } else {
      const char *p = ls + 1;
      while (p < le && (*p == '\t' || *p == ' ')) ++p;
      int64_t a = strtoll(p, nullptr, 10);
      for (int f = 0; f < 2; ++f) {  // skip 2 fields (from orient)
        while (p < le && *p != '\t' && *p != ' ') ++p;
        while (p < le && (*p == '\t' || *p == ' ')) ++p;
      }
      int64_t b = strtoll(p, nullptr, 10);
      int64_t ai = E->node_index(a), bi = E->node_index(b);
      int32_t w = 0;
      if (ai >= 0 && bi >= 0) {
        int64_t slot = E->edge_slot(((uint64_t)ai << 32) | (uint64_t)bi);
        if (slot >= 0) {
          if (atomic_claims) {
            uint8_t prev = __atomic_fetch_or(&claimed[slot], 1, __ATOMIC_RELAXED);
            if (prev) return false;  // duplicate edge: serial fallback
            w = E->counts[E->rc_base + slot];
          } else if (!claimed[slot]) {
            claimed[slot] = 1;
            w = E->counts[E->rc_base + slot];
          }
        }
      }
      o.append(ls, le - ls);
      int n = snprintf(tag, sizeof tag, "\tRC:i:%d\n", w);
      o.append(tag, n);
    }
  } else {
    o.append(ls, le - ls);
    o.push_back('\n');
  }
  return true;
}

bool emit_range(Engine *E, const char *begin, const char *end, const char *hard_end,
                const std::vector<std::vector<int64_t>> &il_offs,
                const std::vector<std::vector<int64_t>> &ol_offs,
                uint8_t *claimed, bool atomic_claims, std::string &o) {
  o.reserve((size_t)((end - begin) * 1.1) + 64);
  const char *p = begin;
  while (p < end) {
    const char *nl = (const char *)memchr(p, '\n', hard_end - p);
    const char *le = nl ? nl : hard_end;
    const char *ls = p;
    while (le > ls && (le[-1] == '\r' || le[-1] == ' ' || le[-1] == '\t')) --le;
    if (le > ls)
      if (!emit_line(E, ls, le, il_offs, ol_offs, claimed, atomic_claims, o))
        return false;
    p = nl ? nl + 1 : hard_end;
  }
  return true;
}

}  // namespace

// Every call stamps its phases on CLOCK_MONOTONIC into the engine's
// emit_stats (read by gafcov_emit_stats): [0, 1] the counts' drain and the
// seen-order binning, [2, 3] the slurp of the GFA, [4, 5] the formatting of
// its lines, [6, 7] every write to out_fd and its close (the time blocked on
// whoever reads the output), [8, 9] the formatting of the novel links; then
// [10] the chunks formatted, [11] the threads that formatted them (1 on the
// serial path, else the fewer of the threads asked for and the chunks),
// [12] the bytes written. The formatted body is held until the novel links
// are formatted too, so all writing is one phase; the bytes are unchanged.
int64_t gafcov_emit_mt(void *h, const char *gfa_in, int out_fd, int n_threads) {
  Engine *E = (Engine *)h;
  int64_t *st = E->emit_stats;
  std::fill(st, st + 13, 0);
  st[0] = mono_ns();
  E->flush_bins();  // binned mode defers increments; drain before reading
  FILE *in = fopen(gfa_in, "rb");
  if (!in) return -1;
  FILE *out = fdopen(dup(out_fd), "wb");
  if (!out) {
    fclose(in);
    return -2;
  }

  // per-node IL/OL offsets in first-seen order
  std::vector<std::vector<int64_t>> il_offs(E->n_nodes), ol_offs(E->n_nodes);
  int64_t hist_total = E->n_nodes ? (E->ol_base[0] - E->il_base[0]) : 0;
  for (int64_t slot : E->seen_order) {
    bool is_il = slot < E->il_base[0] + hist_total;
    const int64_t *base = is_il ? E->il_base : E->ol_base;
    // binary search: node with greatest base <= slot
    int64_t lo = 0, hi = E->n_nodes - 1;
    while (lo < hi) {
      int64_t mid = (lo + hi + 1) / 2;
      if (base[mid] <= slot) lo = mid;
      else hi = mid - 1;
    }
    (is_il ? il_offs : ol_offs)[lo].push_back(slot - base[lo] - 1);
  }
  st[1] = st[2] = mono_ns();

  // slurp the GFA (graph text fits memory by construction of this pipeline)
  fseek(in, 0, SEEK_END);
  long fsize = ftell(in);
  fseek(in, 0, SEEK_SET);
  char *buf = (char *)malloc(fsize + 1);
  if (fread(buf, 1, fsize, in) != (size_t)fsize) {
    free(buf);
    fclose(in);
    fclose(out);
    return -3;
  }
  buf[fsize] = '\n';
  st[3] = st[4] = mono_ns();

  std::vector<uint8_t> claimed(E->n_edges, 0);
  std::vector<std::string> bufs;  // the formatted body, in file order
  if (n_threads < 1) n_threads = 1;
  // PANTAS_EMIT_FORCE_MT lets tests exercise the chunked path on tiny files
  const bool force_mt = getenv("PANTAS_EMIT_FORCE_MT") != nullptr;
  if (n_threads == 1 || (fsize < (8 << 20) && !force_mt)) {
    bufs.resize(1);
    emit_range(E, buf, buf + fsize, buf + fsize + 1, il_offs, ol_offs,
               claimed.data(), false, bufs[0]);
    st[10] = 1;
    st[11] = 1;
  } else {
    // about 4 line-aligned chunks a thread, so that a dynamic worklist
    // evens out chunks of uneven cost; 1 MiB at the least but the last
    // (under the test hook, one line), so no thread is started for a
    // sliver. Every buffer is formatted BEFORE any byte is written, so the
    // duplicate-edge fallback can redo serially even when out_fd is a pipe
    // (formatted output briefly holds ~1.05x the input in RAM)
    const int64_t chunk =
        std::max<int64_t>(force_mt ? 1 : 1 << 20, fsize / (4 * (int64_t)n_threads));
    std::vector<const char *> cuts;
    cuts.push_back(buf);
    while (cuts.back() < buf + fsize) {
      const char *guess = cuts.back() + std::min<int64_t>(chunk, buf + fsize - cuts.back());
      if (guess >= buf + fsize) {
        cuts.push_back(buf + fsize);
        break;
      }
      const char *nl = (const char *)memchr(guess, '\n', buf + fsize - guess);
      cuts.push_back(nl ? nl + 1 : buf + fsize);
    }
    size_t n_chunks = cuts.size() - 1;
    bufs.resize(n_chunks);
    std::atomic<size_t> next{0};
    std::atomic<bool> fail{false};
    const int n_workers = (int)std::min<size_t>(n_threads, n_chunks);
    std::vector<std::thread> threads;
    for (int t = 0; t < n_workers; ++t) {
      threads.emplace_back([&]() {
        size_t c;
        while ((c = next.fetch_add(1)) < n_chunks && !fail.load()) {
          if (!emit_range(E, cuts[c], cuts[c + 1], buf + fsize + 1, il_offs,
                          ol_offs, claimed.data(), true, bufs[c]))
            fail.store(true);
        }
      });
    }
    for (auto &t : threads) t.join();
    st[10] = (int64_t)n_chunks;
    st[11] = n_workers;
    if (fail.load()) {
      // duplicate L line: FILE order (not claim order) must decide which
      // occurrence prints the weight — redo in one ordered pass
      std::fill(claimed.begin(), claimed.end(), 0);
      bufs.assign(1, std::string());
      emit_range(E, buf, buf + fsize, buf + fsize + 1, il_offs, ol_offs,
                 claimed.data(), false, bufs[0]);
    }
  }
  free(buf);
  fclose(in);
  st[5] = st[8] = mono_ns();

  // novel links in first-seen order
  std::string novel;
  char tag[256];
  for (uint64_t key : E->novel_order) {
    int64_t a = E->ids ? E->ids[key >> 32] : (int64_t)(key >> 32) + 1;
    int64_t b = E->ids ? E->ids[key & 0xFFFFFFFFu] : (int64_t)(key & 0xFFFFFFFFu) + 1;
    int n = snprintf(tag, sizeof tag, "L\t%lld\t+\t%lld\t+\t*\tRC:i:%d\tID:Z:N\n",
                     (long long)a, (long long)b, E->novel[key]);
    novel.append(tag, n);
  }
  st[9] = st[6] = mono_ns();

  for (const std::string &b : bufs) st[12] += fwrite(b.data(), 1, b.size(), out);
  st[12] += fwrite(novel.data(), 1, novel.size(), out);
  // surface short writes (ENOSPC, dead pipe): a silently truncated
  // augmented GFA reported as success corrupts every downstream stage
  bool failed = ferror(out) != 0;
  if (fclose(out) != 0) failed = true;
  st[7] = mono_ns();
  return failed ? -3 : 0;
}

// the last emission's 13 numbers (see gafcov_emit_mt)
void gafcov_emit_stats(void *h, int64_t *out13) {
  memcpy(out13, ((Engine *)h)->emit_stats, 13 * sizeof(int64_t));
}

int64_t gafcov_emit(void *h, const char *gfa_in, int out_fd) {
  int t = (int)std::thread::hardware_concurrency();
  const char *env = getenv("PANTAS_EMIT_THREADS");
  if (env && *env) t = atoi(env);
  return gafcov_emit_mt(h, gfa_in, out_fd, t > 0 ? t : 1);
}

// test hook: force binned accumulation regardless of graph size, so the
// binned path gets differential coverage on small fixtures
void gafcov_force_bins(void *h) { ((Engine *)h)->enable_bins(); }

int64_t gafcov_rejected(void *h) { return ((Engine *)h)->rejected; }
int64_t gafcov_skipped(void *h) { return ((Engine *)h)->skipped; }
int64_t gafcov_accepted(void *h) { return ((Engine *)h)->accepted; }

void gafcov_destroy(void *h) { delete (Engine *)h; }

// --- slot-stream session (native feed for the TPU device engine) ----------
//
// Mirrors the host/device split of the reference augmenter (host tokenize,
// device accumulate — scripts/alignments_augmentation_from_gaf.py:134-371):
// the native parser walks a byte range of the GAF and hands fixed-size
// batches of flat slot indices to Python, which scatter-adds them on
// device(s). First-seen sidecars (IL/OL offsets, novel edges, byte
// positions) stay on the engine for byte-identical emission and
// multi-process order merging.
//
// The range is parsed in waves, each about one batch of slots: a wave is cut
// into line-aligned pieces, one a thread, each parsed by an engine of its
// own that only reads the master's seen flags, then merged into the master
// in piece order. The merged stream, sidecars and counters are the serial
// walk's, so every batch is too, whatever the number of pieces.

namespace {

// bytes a slot before the session has seen any: a 150-bp short-read record
// is ~120 B and yields ~25 slots, so the first wave falls short of a batch
// and a second tops it up, rather than run more than a batch ahead
constexpr double FIRST_BYTES_PER_SLOT = 2.0;

// the least bytes a piece of a wave is given: a wave of T > 1 pieces spans
// at least T of these, and takes fewer pieces where the range has fewer
// left, so no thread starts for a sliver of work
constexpr int64_t MIN_PIECE = 512 << 10;

// a piece's engine: the master's tables, its own stream, sidecars, counters
// and scratch; its first sightings are filtered against the master's flags
Engine *clone_piece(const Engine &M) {
  Engine *c = clone_tables(M);
  c->collect_slots = true;
  c->wave_seen = M.counts.data();
  // a bit set here marks a slot that the merge flags on the master, so the
  // bits need no clearing between waves
  c->seen_bits.assign((size_t)(M.total_slots + 63) / 64, 0);
  return c;
}

void reset_piece(Engine &P) {
  P.slot_stream.clear();
  P.seen_order.clear();
  P.seen_pos.clear();
  P.novel.clear();
  P.novel_order.clear();
  P.novel_pos.clear();
  P.rejected = P.skipped = P.accepted = 0;
}

// a piece's sidecars and counters into the master, after the join and in
// piece order: the serial walk would have recorded the same (its slots are
// delivered from the piece's own stream)
void merge_piece(Engine &M, const Engine &P) {
  for (size_t i = 0; i < P.seen_order.size(); ++i) {
    int64_t slot = P.seen_order[i];
    if (M.counts[slot] == 0) {  // no earlier piece or wave saw it
      M.counts[slot] = 1;
      M.seen_order.push_back(slot);
      M.seen_pos.push_back(P.seen_pos[i]);
    }
  }
  for (uint64_t key : P.novel_order) {
    int32_t n = P.novel.at(key);
    auto it = M.novel.find(key);
    if (it == M.novel.end()) {
      M.novel.emplace(key, n);
      M.novel_order.push_back(key);
      M.novel_pos.emplace(key, P.novel_pos.at(key));
    } else {
      it->second += n;
    }
  }
  M.rejected += P.rejected;
  M.skipped += P.skipped;
  M.accepted += P.accepted;
}

struct SlotSession {
  Engine *E;
  char *data = nullptr;
  size_t map_size = 0;
  const char *p = nullptr;  // the end of the last merged wave
  const char *end = nullptr;
  int mapq_thr;
  double max_dv;
  int threads = 1;  // the most pieces a wave may have
  std::vector<std::unique_ptr<Engine>> pieces;  // made as the waves need them
  // the streams slots are delivered from, in order: the master's (what the
  // last wave left undelivered), then each of the last wave's pieces';
  // (seg, off) is the next slot to deliver
  std::vector<std::vector<int32_t> *> segs;
  size_t seg = 0, off = 0;
  int64_t pending = 0;   // parsed, not delivered
  int64_t produced = 0;  // slots parsed, for the waves' bytes a slot
  // totals of the session (gafcov_slots_stats): nanoseconds in the parse
  // (waves and merges) and in the hand-off, records parsed, bytes walked,
  // slots delivered, the pieces a wave, the waves, nanoseconds in merges
  int64_t parse_ns = 0, handoff_ns = 0, records = 0, bytes = 0, delivered = 0;
  int64_t waves = 0, merge_ns = 0;
};

// parse the next span of the range, sized from the bytes a slot seen so far
// to yield about `want` slots, in up to `threads` line-aligned pieces at once
void run_wave(SlotSession &S, int64_t want) {
  Engine &E = *S.E;
  // what waits (under a batch) moves to the master's stream, as the pieces
  // start anew
  std::vector<int32_t> &carry = E.slot_stream;
  if (S.seg == 0) carry.erase(carry.begin(), carry.begin() + S.off);
  else carry.clear();
  for (size_t k = std::max<size_t>(S.seg, 1); k < S.segs.size(); ++k)
    carry.insert(carry.end(), S.segs[k]->begin() + (k == S.seg ? S.off : 0),
                 S.segs[k]->end());
  S.seg = S.off = 0;
  double per_slot = S.produced ? (double)S.bytes / S.produced : FIRST_BYTES_PER_SLOT;
  const char *lo = S.p;
  int64_t left = S.end - lo;
  int T = (int)std::max<int64_t>(1, std::min<int64_t>(S.threads, left / MIN_PIECE));
  // a sixteenth more than asked, so that a wave rarely falls short of a batch
  double span = std::max(want * per_slot * (17.0 / 16.0) + 1,
                         T > 1 ? (double)(T * MIN_PIECE) : 0.0);
  const char *hi = span >= (double)left ? S.end : line_cut(lo + (int64_t)span, S.end);
  while ((int)S.pieces.size() < T) S.pieces.emplace_back(clone_piece(E));
  S.segs.resize(1);
  for (int t = 0; t < T; ++t) S.segs.push_back(&S.pieces[t]->slot_stream);
  int64_t before = S.pending;
  std::vector<const char *> cut(T + 1);
  cut[0] = lo;
  cut[T] = hi;
  for (int t = 1; t < T; ++t) cut[t] = line_cut(lo + (hi - lo) * t / T, hi);
  std::vector<int64_t> recs(T, 0);
  auto piece = [&](int t) {
    reset_piece(*S.pieces[t]);
    recs[t] = process_range(*S.pieces[t], S.data, cut[t], cut[t + 1], S.mapq_thr, S.max_dv);
  };
  std::vector<std::thread> workers;
  for (int t = 1; t < T; ++t) workers.emplace_back(piece, t);
  piece(0);
  for (auto &w : workers) w.join();
  int64_t t0 = mono_ns();
  for (int t = 0; t < T; ++t) {
    merge_piece(E, *S.pieces[t]);
    S.records += recs[t];
  }
  S.merge_ns += mono_ns() - t0;
  S.pending = 0;
  for (auto *v : S.segs) S.pending += (int64_t)v->size();
  S.produced += S.pending - before;
  S.bytes += hi - lo;
  S.p = hi;
  S.waves++;
}

// up to cap slots from the front of what is parsed and not delivered
int64_t deliver(SlotSession &S, int32_t *buf, int64_t cap) {
  int64_t n = 0;
  while (n < cap && S.seg < S.segs.size()) {
    const std::vector<int32_t> &v = *S.segs[S.seg];
    size_t take = std::min<size_t>(v.size() - S.off, (size_t)(cap - n));
    memcpy(buf + n, v.data() + S.off, take * sizeof(int32_t));
    n += (int64_t)take;
    S.off += take;
    if (S.off == v.size()) {
      S.seg++;
      S.off = 0;
    }
  }
  S.pending -= n;
  S.delivered += n;
  return n;
}
}  // namespace

// lo/hi: byte range to process (hi < 0 means EOF); threads: the most pieces
// a wave may have; returns nullptr on error or when the slot space does not
// fit the int32 stream
void *gafcov_slots_begin(void *h, const char *path, int64_t lo, int64_t hi,
                         int mapq_thr, double max_dv, int threads) {
  Engine *E = (Engine *)h;
  if (E->total_slots > INT32_MAX) return nullptr;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  SlotSession *S = new SlotSession();
  S->E = E;
  S->mapq_thr = mapq_thr;
  S->max_dv = max_dv;
  if (st.st_size > 0) {
    S->map_size = st.st_size;
    S->data = (char *)mmap(nullptr, S->map_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (S->data == MAP_FAILED) {
      close(fd);
      delete S;
      return nullptr;
    }
    madvise(S->data, S->map_size, MADV_SEQUENTIAL);
    madvise(S->data, S->map_size, MADV_WILLNEED);
    int64_t size = (int64_t)S->map_size;
    if (hi < 0 || hi > size) hi = size;
    if (lo < 0) lo = 0;
    if (lo > hi) lo = hi;
    S->p = S->data + lo;
    S->end = S->data + hi;
  }
  close(fd);
  S->threads = std::max(threads, 1);
  S->segs.push_back(&E->slot_stream);
  return S;
}

// Fill buf with up to cap slot indices; returns the count (0 = EOF drained).
// Parses a wave whenever fewer than cap slots wait, so it runs at most one
// wave ahead; counters and seen sidecars reach the engine wave by wave.
int64_t gafcov_slots_next(void *s, int32_t *buf, int64_t cap) {
  SlotSession *S = (SlotSession *)s;
  int64_t t0 = mono_ns();
  while (S->pending < cap && S->p < S->end) run_wave(*S, cap - S->pending);
  int64_t t1 = mono_ns();
  int64_t n = deliver(*S, buf, cap);
  S->parse_ns += t1 - t0;
  S->handoff_ns += mono_ns() - t1;
  return n;
}

// current parse position (absolute byte offset, the end of the last merged
// wave) — a valid resume point once the pending residual has been drained
// (gafcov_slots_take_pending)
int64_t gafcov_slots_pos(void *s) {
  SlotSession *S = (SlotSession *)s;
  return S->data ? (int64_t)(S->p - S->data) : 0;
}

// drain slots already parsed but not yet delivered (no further parsing) —
// the residual a checkpoint must flush so that (pos, counts) is consistent
int64_t gafcov_slots_take_pending(void *s, int32_t *buf, int64_t cap) {
  SlotSession *S = (SlotSession *)s;
  int64_t t0 = mono_ns();
  int64_t n = deliver(*S, buf, cap);
  S->handoff_ns += mono_ns() - t0;
  return n;
}

// the session's totals so far: [parse_ns, handoff_ns, records, bytes,
// delivered, threads (the most pieces a wave had), waves, merge_ns]; read
// them before gafcov_slots_end
void gafcov_slots_stats(void *s, int64_t *out8) {
  SlotSession *S = (SlotSession *)s;
  int64_t v[8] = {S->parse_ns, S->handoff_ns, S->records, S->bytes, S->delivered,
                  std::max<int64_t>(1, (int64_t)S->pieces.size()), S->waves, S->merge_ns};
  memcpy(out8, v, sizeof v);
}

void gafcov_slots_end(void *s) {
  SlotSession *S = (SlotSession *)s;
  S->E->slot_stream.clear();
  S->E->slot_stream.shrink_to_fit();
  if (S->data) munmap(S->data, S->map_size);
  delete S;
}

// Overwrite the engine's counts with the device-reduced vector (the device
// result is then what gafcov_emit / the sidecar accessors read).
void gafcov_counts_set(void *h, const int32_t *vals) {
  Engine *E = (Engine *)h;
  memcpy(E->counts.data(), vals, E->counts.size() * sizeof(int32_t));
}

// byte offset of each first sighting, aligned with gafcov_seen_order
const int64_t *gafcov_seen_pos(void *h) {
  return ((Engine *)h)->seen_pos.data();
}

// first-seen byte offsets aligned with gafcov_novel_fill's key order
void gafcov_novel_pos_fill(void *h, int64_t *poss) {
  Engine *E = (Engine *)h;
  for (size_t i = 0; i < E->novel_order.size(); ++i) {
    auto it = E->novel_pos.find(E->novel_order[i]);
    poss[i] = it == E->novel_pos.end() ? -1 : it->second;
  }
}

// --- k-mer index utilities (mapper support) -------------------------------
// This environment trap-emulates AVX numpy kernels (catastrophically slow
// elementwise u64 ops), so the mapper's index build runs natively here.

static const uint8_t BASE2[256] = {
    // defaults 0 (A); set C/G/T below via initializer trick in kidx_pack
};

// pack 2-bit k-mers of seq[0..len) into out[0..len-k]
void kidx_pack(const char *seq, int64_t len, int k, uint64_t *out) {
  auto code = [](char c) -> uint64_t {
    switch (c) {
      case 'C': case 'c': return 1;
      case 'G': case 'g': return 2;
      case 'T': case 't': return 3;
      default: return 0;
    }
  };
  (void)BASE2;
  if (len < k) return;
  uint64_t mask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  uint64_t cur = 0;
  for (int64_t i = 0; i < len; ++i) {
    cur = ((cur << 2) | code(seq[i])) & mask;
    if (i >= k - 1) out[i - k + 1] = cur;
  }
}

// stable argsort (kmers asc); permutes kmers/pids/poss in place
void kidx_sort(uint64_t *kmers, int32_t *pids, int32_t *poss, int64_t n) {
  // stable LSD radix over (key, original index) pairs — 16-bit digits,
  // only as many passes as the key width needs (2-bit-packed 21-mers use
  // 42 bits -> 3 passes). The previous indirect-comparator stable_sort
  // measured 84 s on the 100 Mbp mapper index; counting passes are
  // sequential-bandwidth bound instead.
  // satellites (pid, pos) travel WITH the key — a 16-byte record, so no
  // final random gather over the satellite arrays (192M random 4-byte
  // reads measured ~15 s on this host); buffers are heap-uninitialized
  // (6 GB of std::vector zero-init is real time at these sizes)
  struct E {
    uint64_t k;
    int32_t pid, pos;
  };
  std::unique_ptr<E[]> ap(new E[n]), bp(new E[n]);
  E *a = ap.get(), *b = bp.get();
  // 11-bit digits: 2048 write streams stay TLB/cache-local; one fused
  // read computes every pass's histogram up front
  constexpr int DB = 11;
  constexpr int64_t NB = 1 << DB;
  // kidx_pack emits up to 64-bit keys (k<=32), so the plan must cover the
  // full width: 6 passes x 11 bits = 66 bits. The maxk early-break below
  // skips the empty high passes, so the common 2-bit 21-mer (42 bits) still
  // runs only 4 passes.
  constexpr int NPASS = 6;
  static_assert(NPASS * DB >= 64, "digit plan must cover the key width");
  std::vector<int64_t> cnt(NPASS * NB, 0);
  uint64_t maxk = 1;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t k = kmers[i];
    a[i] = {k, pids[i], poss[i]};
    maxk |= k;
    for (int p = 0; p < NPASS; ++p) cnt[p * NB + ((k >> (p * DB)) & (NB - 1))]++;
  }
  for (int p = 0; p < NPASS; ++p) {
    if ((maxk >> (p * DB)) == 0) break;  // key width exhausted
    int64_t *c = cnt.data() + p * NB;
    int64_t run = 0;
    for (int64_t d = 0; d < NB; ++d) {
      int64_t x = c[d];
      c[d] = run;
      run += x;
    }
    int shift = p * DB;
    for (int64_t i = 0; i < n; ++i) b[c[(a[i].k >> shift) & (NB - 1)]++] = a[i];
    std::swap(a, b);
  }
  for (int64_t i = 0; i < n; ++i) {
    kmers[i] = a[i].k;
    pids[i] = a[i].pid;
    poss[i] = a[i].pos;
  }
}

// ---- fast GFA structural scan (graph/compiler.py::compile_gfa backend) ----
//
// Extracts only what the tensor compiler needs — integer node ids, sequence
// lengths, raw edge id pairs — in one mmap pass. Tags (EX/IL/OL/...) are
// never touched. `ok` drops to 0 on an id that is not a canonical integer,
// signalling the Python caller to fall back to the general parser.

namespace {
struct GfaScan {
  std::vector<int64_t> ids;
  std::vector<int32_t> lens;
  std::vector<int64_t> esrc, edst;
  int ok = 1;
};

// The canonical decimal id at p (before le): digits only, no leading zero,
// within int64 — exactly the spellings that str(int(id)) gives back, so the
// caller may name a segment by its id. Returns the end of the digits, or
// nullptr on '007', '+7', ' 7', '-7', an overflow or no digit at all.
const char *canonical_id(const char *p, const char *le, int64_t *id) {
  const char *q = p;
  int64_t v = 0;
  for (; q < le && *q >= '0' && *q <= '9'; ++q) {
    int d = *q - '0';
    if (v > (INT64_MAX - d) / 10) return nullptr;
    v = v * 10 + d;
  }
  if (q == p || (*p == '0' && q > p + 1)) return nullptr;
  *id = v;
  return q;
}
}  // namespace

void *gfa_scan(const char *path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  GfaScan *G = new GfaScan();
  if (st.st_size == 0) {
    close(fd);
    return G;
  }
  size_t size = st.st_size;
  char *data = (char *)mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (data == MAP_FAILED) {
    delete G;
    return nullptr;
  }
  madvise(data, size, MADV_SEQUENTIAL);
  const char *p = data;
  const char *end = data + size;
  while (p < end) {
    const char *nl = (const char *)memchr(p, '\n', end - p);
    const char *le = nl ? nl : end;
    if (le > p + 2 && p[1] == '\t') {
      if (p[0] == 'S') {
        // S \t id \t seq [\t tags...]
        int64_t id;
        const char *q = canonical_id(p + 2, le, &id);
        if (!q || q == le || *q != '\t') {
          G->ok = 0;
          break;
        }
        ++q;
        const char *t = (const char *)memchr(q, '\t', le - q);
        const char *seq_end = t ? t : le;
        G->ids.push_back(id);
        G->lens.push_back((int32_t)(seq_end - q));
      } else if (p[0] == 'L') {
        // L \t a \t +|- \t b ...
        int64_t a, b;
        const char *q = canonical_id(p + 2, le, &a);
        if (!q || q + 2 >= le || *q != '\t' || q[2] != '\t') {
          G->ok = 0;
          break;
        }
        const char *r = canonical_id(q + 3, le, &b);
        if (!r || (r < le && *r != '\t')) {
          G->ok = 0;
          break;
        }
        G->esrc.push_back(a);
        G->edst.push_back(b);
      }
    }
    if (!nl) break;
    p = nl + 1;
  }
  munmap(data, size);
  return G;
}

int gfa_scan_ok(void *h) { return ((GfaScan *)h)->ok; }
int64_t gfa_scan_n_nodes(void *h) { return ((GfaScan *)h)->ids.size(); }
int64_t gfa_scan_n_edges(void *h) { return ((GfaScan *)h)->esrc.size(); }
const int64_t *gfa_scan_ids(void *h) { return ((GfaScan *)h)->ids.data(); }
const int32_t *gfa_scan_lens(void *h) { return ((GfaScan *)h)->lens.data(); }
const int64_t *gfa_scan_esrc(void *h) { return ((GfaScan *)h)->esrc.data(); }
const int64_t *gfa_scan_edst(void *h) { return ((GfaScan *)h)->edst.data(); }
void gfa_scan_free(void *h) { delete (GfaScan *)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Clip-boundary site scanner (the `novel-sites` extension, events/sites.py).
//
// Streams a GAF and accumulates soft-clip pile-ups: alignments that start
// (acceptor side) or end (donor side) at a node-interior offset with
// >= min_clip unaligned query bases hanging off that boundary. Behavioral
// contract: pantas_tpu_torch/events/sites.py::_boundary_events, exactly — the
// Python detector is the oracle (differential-tested). No cs parsing is
// needed (clip lengths come from the query columns), so this scans at
// memory speed for production-scale GAFs.

namespace {

struct ClipSites {
  std::unordered_map<int64_t, int32_t> nlen;  // node id -> sequence length
  // key = (id << 21) | (fwd_off << 2) | side   (side: 0=start, 1=end)
  std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> piles;  // count, clipmax
  int64_t accepted = 0;
};

inline bool tok_int(const char *s, const char *e, int64_t &out) {
  if (s >= e) return false;
  for (const char *p = s; p < e; ++p)
    if (!is_dig(*p)) return false;
  out = parse_u(s, e);
  return true;
}

void clipsites_line(ClipSites &C, const char *line, const char *lend,
                    int mapq_thr, double max_dv, int min_clip) {
  Field f[13];
  int nf = 0;
  const char *p = line;
  while (p < lend && nf < 12) {
    while (p < lend && (*p == '\t' || *p == ' ')) ++p;
    if (p >= lend) break;
    const char *q = p;
    while (q < lend && *q != '\t' && *q != ' ') ++q;
    f[nf].s = p;
    f[nf].e = q;
    ++nf;
    p = q;
  }
  if (nf < 12) return;
  if (f[11].as_int() < mapq_thr) return;
  if (f[5].e - f[5].s == 1 && *f[5].s == '*') return;

  // dv:f: tag (first match wins, reference regex semantics — same scan as
  // process_line)
  while (p < lend && (*p == '\t' || *p == ' ')) ++p;
  for (const char *t = p; t + 4 < lend; ++t) {
    if (t[0] == 'd' && t[1] == 'v' && t[2] == ':' && t[3] == 'f' &&
        t[4] == ':') {
      const char *q = t + 5;
      if (q < lend && is_dig(*q)) {
        const char *d = q;
        while (d < lend && is_dig(*d)) ++d;
        if (d < lend && *d == '.' && d + 1 < lend && is_dig(d[1])) {
          ++d;
          while (d < lend && is_dig(*d)) ++d;
        }
        char tmp[64];
        size_t n = (size_t)(d - q) < sizeof(tmp) - 1 ? (size_t)(d - q)
                                                     : sizeof(tmp) - 1;
        memcpy(tmp, q, n);
        tmp[n] = 0;
        if (strtod(tmp, nullptr) > max_dv) return;
        break;  // first DIGIT-BEARING match wins (oracle regex semantics);
      }         // a bare 'dv:f:' literal must not stop the scan
    }
  }

  const char *ps = f[5].s, *pe = f[5].e;
  char sep = *ps;
  if (sep != '>' && sep != '<') return;
  bool rev = sep == '<';
  // walk ALL steps: the first/last ALIGNED base can sit in an interior
  // node (spliced joins emit walks whose terminal node has zero aligned
  // span — see events/sites.py::_boundary_events), so locate the covered
  // nodes by cumulative step lengths
  int64_t ids_buf[512];
  int64_t cum_buf[513];
  int64_t *ids = ids_buf;
  int64_t *cum = cum_buf;
  std::vector<int64_t> ids_dyn, cum_dyn;  // rare >512-step walks (the
  int cap = 512;                          // Python oracle has no cap)
  int nsteps = 0;
  cum[0] = 0;
  const char *sp = ps + 1;
  while (sp < pe) {
    const char *se = sp;
    while (se < pe && *se != sep) ++se;
    int64_t id;
    if (!tok_int(sp, se, id)) return;
    auto it = C.nlen.find(id);
    if (it == C.nlen.end()) return;
    if (nsteps >= cap) {
      if (ids_dyn.empty()) {  // first spill from the stack buffers
        ids_dyn.assign(ids, ids + nsteps);
        cum_dyn.assign(cum, cum + nsteps + 1);
      }
      cap *= 4;
      ids_dyn.resize(cap);
      cum_dyn.resize(cap + 1);
      ids = ids_dyn.data();
      cum = cum_dyn.data();
    }
    ids[nsteps] = id;
    cum[nsteps + 1] = cum[nsteps] + it->second;
    ++nsteps;
    sp = se < pe ? se + 1 : pe;
  }
  if (nsteps == 0) return;

  int64_t qlen = f[1].as_int(), qstart = f[2].as_int(), qend = f[3].as_int();
  int64_t pstart = f[7].as_int(), pend = f[8].as_int();
  int64_t ws = pstart;
  // GAF col 9 here is the INCLUSIVE last aligned base (mapper writes
  // pend_excl - 1) — see events/sites.py::_boundary_events
  int64_t we_abs = pend;
  if (ws < 0 || we_abs < ws || we_abs >= cum[nsteps]) return;
  int i = 0, j = nsteps - 1;
  while (cum[i + 1] <= ws) ++i;
  while (cum[j] > we_abs) --j;
  int64_t first_id = ids[i], last_id = ids[j];
  int64_t len_first = cum[i + 1] - cum[i], len_last = cum[j + 1] - cum[j];
  int64_t off_s = ws - cum[i], off_e = we_abs - cum[j];
  int64_t fs = rev ? len_first - 1 - off_s : off_s;
  int64_t fe = rev ? len_last - 1 - off_e : off_e;
  int64_t clip_head = qstart;
  int64_t clip_tail = qlen - qend;
  C.accepted++;

  auto add = [&C](int side, int64_t id, int64_t off, int64_t clip) {
    if (off < 0 || off >= (1 << 19) || id < 0 || id >= ((int64_t)1 << 43))
      return;
    uint64_t key = ((uint64_t)id << 21) | ((uint64_t)off << 2) | (uint64_t)side;
    auto &v = C.piles[key];
    v.first++;
    if ((int32_t)clip > v.second) v.second = (int32_t)clip;
  };
  if (!rev) {
    if (clip_head >= min_clip) add(0, first_id, fs, clip_head);
    if (clip_tail >= min_clip) add(1, last_id, fe, clip_tail);
  } else {
    if (clip_head >= min_clip) add(1, first_id, fs, clip_head);
    if (clip_tail >= min_clip) add(0, last_id, fe, clip_tail);
  }
}

}  // namespace

extern "C" {

void *clipsites_create(int64_t n, const int64_t *ids, const int32_t *lens) {
  // the pile key packs offset into 19 bits and id into 43; a graph outside
  // that envelope cannot be represented, so refuse the handle up front
  // (the Python caller falls back to the host scanner) instead of letting
  // add() silently drop sites and diverge from the Python oracle
  for (int64_t i = 0; i < n; ++i)
    if (lens[i] >= (1 << 19) || ids[i] < 0 || ids[i] >= ((int64_t)1 << 43))
      return nullptr;
  ClipSites *C = new ClipSites();
  C->nlen.reserve((size_t)n * 2);
  for (int64_t i = 0; i < n; ++i) C->nlen.emplace(ids[i], lens[i]);
  return C;
}

int64_t clipsites_process_file(void *h, const char *path, int mapq_thr,
                               double max_dv, int min_clip) {
  ClipSites *C = (ClipSites *)h;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return st.st_size == 0 ? 0 : -1;
  }
  char *base = (char *)mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return -1;
  madvise(base, st.st_size, MADV_SEQUENTIAL);  // advice is an enum,
  madvise(base, st.st_size, MADV_WILLNEED);    // not a bitmask
  const char *p = base, *end = base + st.st_size;
  int64_t lines = 0;
  while (p < end) {
    const char *nl = (const char *)memchr(p, '\n', end - p);
    const char *le = nl ? nl : end;
    const char *ls = p;
    while (le > ls && (le[-1] == '\r' || le[-1] == ' ')) --le;
    if (le > ls) {
      clipsites_line(*C, ls, le, mapq_thr, max_dv, min_clip);
      ++lines;
    }
    p = nl ? nl + 1 : end;
  }
  munmap(base, st.st_size);
  return lines;
}

int64_t clipsites_count(void *h) {
  return (int64_t)((ClipSites *)h)->piles.size();
}

void clipsites_fill(void *h, int64_t *node, int32_t *off, int8_t *side,
                    int32_t *count, int32_t *clipmax) {
  ClipSites *C = (ClipSites *)h;
  int64_t i = 0;
  for (const auto &kv : C->piles) {
    node[i] = (int64_t)(kv.first >> 21);
    off[i] = (int32_t)((kv.first >> 2) & ((1 << 19) - 1));
    side[i] = (int8_t)(kv.first & 3);
    count[i] = kv.second.first;
    clipmax[i] = kv.second.second;
    ++i;
  }
}

void clipsites_destroy(void *h) { delete (ClipSites *)h; }

}  // extern "C"
