// Native path-guided read aligner: the mapper's per-read hot path.
//
// Faithful port of pantas_tpu/mapping/mapper.py (seed -> Kadane
// max-identity-window extension -> two-piece spliced join with node-boundary
// snapping). Python keeps index construction + GAF formatting; this core
// returns piece coordinates (forward-path), strand, and the oriented cs
// string, and must produce byte-identical GAF through the same formatter.

#include <time.h>
#include <unistd.h>
#if defined(__SSE2__)
#include <emmintrin.h>
#endif
#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int MISMATCH_PENALTY = 4;
constexpr double MAX_MISMATCH_FRAC = 0.08;
constexpr int MIN_SPAN = 20;

// per-phase wall accounting for the speed-of-light bisection
// (docs/PERFORMANCE.md "Mapper"): a few clock_gettime pairs per read
// (~25 ns each) against a ~27 us/read core — ~1% overhead, always on.
// Slots: 0 seed (pack+bisect+vote sort), 1 extend (Kadane top-4),
// 2 join (snap/indel split search), 3 mapq (secondary-candidate scan),
// 4 format (cs + GAF line), 5 io (fastq read + output write),
// 6 best_piece calls, 7 reads.
struct Phases {
  int64_t ns[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  void add(const Phases &o) {
    for (int i = 0; i < 8; ++i) ns[i] += o.ns[i];
  }
};

inline int64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

struct Aligner {
  const char *seqs = nullptr;        // concatenated path sequences
  const int64_t *seq_off = nullptr;  // n_paths+1
  const int64_t *node_off = nullptr; // concatenated per-path node offsets
  const int64_t *node_idx = nullptr; // n_paths+1 (CSR into node_off)
  const int64_t *node_ids = nullptr; // node ids (int64), aligned with node_off
  int n_paths = 0;
  const uint64_t *kmers = nullptr;
  const int32_t *pids = nullptr;
  const int32_t *poss = nullptr;
  int64_t n_kmers = 0;
  int k = 21;
  int max_hits = 64;
  Phases phases;          // merged under phases_mu at chunk boundaries
  std::mutex phases_mu;
  // prefix-bucket directory over the sorted kmer array: bucket[b] is the
  // first index whose key has top bits == b, so each seed lookup narrows
  // to a ~32-entry range before bisecting. The plain full-array bisection
  // measured 25.5 us/read at genome scale (192M keys = 1.5 GB, every
  // probe a cache miss) — 72% of the per-read wall.
  std::vector<int64_t> bucket;
  int bucket_shift = 0;

  const char *pseq(int pi) const { return seqs + seq_off[pi]; }
  int64_t plen(int pi) const { return seq_off[pi + 1] - seq_off[pi]; }
  int64_t n_nodes(int pi) const { return node_idx[pi + 1] - node_idx[pi]; }
  const int64_t *offs(int pi) const { return node_off + node_idx[pi]; }
  const int64_t *ids(int pi) const { return node_ids + node_idx[pi]; }
};

struct Piece {
  int path = -1;
  int64_t qstart = 0, qend = 0;  // oriented read coords
  int64_t pstart = 0, pend = 0;  // forward path coords
  int64_t mism = 0;
  int64_t span() const { return pend - pstart; }
};

struct Vote {
  int pid;
  int64_t diag;
  int count;
};

struct Gap {
  int kind = 0;  // 0 none, 1 deletion ('-'), 2 insertion ('+')
  std::string payload;  // lowercased deleted-path / inserted-read bases
};

inline char comp(char c) {
  switch (c) {
    case 'A': return 'T'; case 'a': return 't';
    case 'C': return 'G'; case 'c': return 'g';
    case 'G': return 'C'; case 'g': return 'c';
    case 'T': return 'A'; case 't': return 'a';
    default: return c;
  }
}

inline int code(char c) {
  // parity with the Python packer: only N skips a seed; other characters
  // (degenerate IUPAC codes) pack as 0 like _BASE_CODE's default
  switch (c) {
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    case 'N': case 'n': return -1;
    default: return 0;
  }
}

// votes in first-seen order (parity with Python dict semantics)
void seed(const Aligner &A, const char *read, int64_t L, int64_t qlo,
          int64_t qhi, std::vector<Vote> &votes) {
  votes.clear();
  int64_t span = qhi - qlo;
  int k = A.k;
  if (span < k) return;
  int64_t offs[5] = {qlo, qlo + span / 4, qlo + span / 2, qlo + (3 * span) / 4,
                     qhi - k};
  // python: sorted(set(...)) — dedupe & sort
  std::sort(offs, offs + 5);
  // software pipeline: pack every offset first and prefetch its bucket
  // directory lines, so the 5 independent lookups overlap their DRAM
  // misses instead of serializing them
  int64_t prev = -1;
  uint64_t packs[5];
  int64_t qs[5];
  int np = 0;
  for (int oi = 0; oi < 5; ++oi) {
    int64_t q = offs[oi];
    if (q == prev) continue;
    prev = q;
    if (q < qlo || q + k > qhi) continue;
    uint64_t packed = 0;
    bool ok = true;
    for (int j = 0; j < k; ++j) {
      int c = code(read[q + j]);
      if (c < 0) { ok = false; break; }
      packed = (packed << 2) | (uint64_t)c;
    }
    if (!ok) continue;
    packs[np] = packed;
    qs[np] = q;
    ++np;
    __builtin_prefetch(&A.bucket[packed >> A.bucket_shift], 0, 1);
  }
  int64_t ranges[5][2];
  for (int i = 0; i < np; ++i) {
    uint64_t b = packs[i] >> A.bucket_shift;
    ranges[i][0] = A.bucket[b];
    ranges[i][1] = A.bucket[b + 1];
    // pull the narrowed kmer range in while the next lookup proceeds
    __builtin_prefetch(&A.kmers[(ranges[i][0] + ranges[i][1]) / 2], 0, 1);
  }
  for (int i = 0; i < np; ++i) {
    uint64_t packed = packs[i];
    int64_t q = qs[i];
    // bucket-narrowed binary range search (identical result to a
    // full-array bisection; the directory only bounds the range)
    int64_t lo = ranges[i][0], hi = ranges[i][1];
    while (lo < hi) { int64_t m = (lo + hi) / 2; if (A.kmers[m] < packed) lo = m + 1; else hi = m; }
    int64_t lo2 = lo; hi = ranges[i][1];
    while (lo2 < hi) { int64_t m = (lo2 + hi) / 2; if (A.kmers[m] <= packed) lo2 = m + 1; else hi = m; }
    if (lo2 - lo > A.max_hits) continue;
    for (int64_t j = lo; j < lo2; ++j) {
      int pid = A.pids[j];
      int64_t diag = (int64_t)A.poss[j] - q;
      bool found = false;
      for (auto &v : votes)
        if (v.pid == pid && v.diag == diag) { v.count++; found = true; break; }
      if (!found) votes.push_back({pid, diag, 1});
    }
  }
}

// Kadane max-identity window; fills piece (no ops — recomputed at emit).
// The per-byte score chain is equivalent to a segment scan over mismatch
// positions: inside a match run the score rises monotonically (best can
// only move at run ends), and it only drops/resets at mismatches — so we
// extract the mismatch positions with 16-byte SSE2 compares and run
// Kadane over the (few) mismatches instead of every byte. Bit-identical
// window selection by construction; additionally byte-verified against
// the scalar loop on a 1M-read genome GAF.
bool extend(const Aligner &A, const char *read, int pid, int64_t diag,
            int64_t qlo, int64_t qhi, Piece &out) {
  const char *ps = A.pseq(pid);
  int64_t lo = std::max(qlo, -diag);
  int64_t hi = std::min(qhi, A.plen(pid) - diag);
  if (hi - lo <= 0) return false;

  // mismatch positions in [lo, hi)
  int64_t mm[512];
  int nmm = 0;
  int64_t i = lo;
#if defined(__SSE2__)
  for (; i + 16 <= hi && nmm + 16 <= 512; i += 16) {
    __m128i a = _mm_loadu_si128((const __m128i *)(read + i));
    __m128i b = _mm_loadu_si128((const __m128i *)(ps + diag + i));
    unsigned mask = 0xFFFFu ^ (unsigned)_mm_movemask_epi8(_mm_cmpeq_epi8(a, b));
    while (mask) {
      int bit = __builtin_ctz(mask);
      mm[nmm++] = i + bit;
      mask &= mask - 1;
    }
  }
#endif
  for (; i < hi && nmm < 512; ++i)
    if (read[i] != ps[diag + i]) mm[nmm++] = i;
  if (i < hi) {
    // pathological mismatch density beyond the buffer: scalar fallback
    int64_t best_s = lo, best_e = lo, cur_s = lo;
    int64_t best_score = 0, cur = 0;
    for (int64_t k = lo; k < hi; ++k) {
      cur += (read[k] == ps[diag + k]) ? 1 : -MISMATCH_PENALTY;
      if (cur > best_score) { best_score = cur; best_s = cur_s; best_e = k + 1; }
      if (cur < 0) { cur = 0; cur_s = k + 1; }
    }
    if (best_e <= best_s) return false;
    int64_t mism = 0;
    for (int64_t k = best_s; k < best_e; ++k)
      if (read[k] != ps[diag + k]) ++mism;
    out.path = pid;
    out.qstart = best_s;
    out.qend = best_e;
    out.pstart = diag + best_s;
    out.pend = diag + best_e;
    out.mism = mism;
    return true;
  }

  int64_t best_s = lo, best_e = lo, cur_s = lo;
  int64_t best_score = 0, cur = 0;
  int64_t prev = lo;
  int best_mm_hi = 0;  // mismatches before best_e
  for (int k = 0; k <= nmm; ++k) {
    int64_t m = (k < nmm) ? mm[k] : hi;
    int64_t run = m - prev;  // matches since prev
    if (run > 0) {
      cur += run;
      if (cur > best_score) {
        best_score = cur;
        best_s = cur_s;
        best_e = m;
        best_mm_hi = k;
      }
    }
    if (k == nmm) break;
    cur -= MISMATCH_PENALTY;
    if (cur < 0) {
      cur = 0;
      cur_s = m + 1;
    }
    prev = m + 1;
  }
  if (best_e <= best_s) return false;
  // mismatches inside [best_s, best_e)
  int mm_lo = 0;
  while (mm_lo < nmm && mm[mm_lo] < best_s) ++mm_lo;
  out.path = pid;
  out.qstart = best_s;
  out.qend = best_e;
  out.pstart = diag + best_s;
  out.pend = diag + best_e;
  out.mism = best_mm_hi - mm_lo;
  return true;
}

// node index containing path position pos (bisect_right(offsets,pos)-1);
// declared early for node_interval
int64_t node_at(const Aligner &A, int pid, int64_t pos);

// secondary-placement candidate: single-piece score + covered node-id range
struct Cand {
  int64_t score, lo, hi;
};

// (min,max) node id covered by a piece — the placement-identity key. Node
// ids are topologically sorted, so same-locus placements (same exon via a
// different transcript path) intersect and do NOT count as secondary hits.
void node_interval(const Aligner &A, const Piece &p, int64_t &lo, int64_t &hi) {
  int64_t i0 = node_at(A, p.path, p.pstart);
  int64_t i1 = node_at(A, p.path, p.pend - 1);
  int64_t a = A.ids(p.path)[i0], b = A.ids(p.path)[i1];
  lo = a <= b ? a : b;
  hi = a <= b ? b : a;
}

bool best_piece(const Aligner &A, const char *read, int64_t L, int64_t qlo,
                int64_t qhi, bool use_excl, int excl_pid, int64_t excl_diag,
                Piece &best, std::vector<Vote> &scratch, Phases *ph,
                std::vector<Cand> *collect = nullptr) {
  int64_t t0 = now_ns();
  seed(A, read, L, qlo, qhi, scratch);
  if (use_excl) {
    for (size_t i = 0; i < scratch.size(); ++i)
      if (scratch[i].pid == excl_pid && scratch[i].diag == excl_diag) {
        scratch.erase(scratch.begin() + i);
        break;
      }
  }
  if (scratch.empty()) {
    ph->ns[0] += now_ns() - t0;
    ph->ns[6]++;
    return false;
  }
  std::stable_sort(scratch.begin(), scratch.end(),
                   [](const Vote &a, const Vote &b) { return a.count > b.count; });
  int64_t t1 = now_ns();
  ph->ns[0] += t1 - t0;
  ph->ns[6]++;
  bool have = false;
  size_t top = std::min(scratch.size(), (size_t)4);
  for (size_t t = 0; t < top; ++t) {
    Piece p;
    if (!extend(A, read, scratch[t].pid, scratch[t].diag, qlo, qhi, p)) continue;
    if (p.span() < MIN_SPAN) continue;
    if ((double)p.mism > MAX_MISMATCH_FRAC * (double)p.span()) continue;
    if (collect) {
      Cand c;
      c.score = p.span() - MISMATCH_PENALTY * p.mism;
      node_interval(A, p, c.lo, c.hi);
      collect->push_back(c);
    }
    if (!have || (p.span() - MISMATCH_PENALTY * p.mism) >
                     (best.span() - MISMATCH_PENALTY * best.mism)) {
      best = p;
      have = true;
    }
  }
  ph->ns[1] += now_ns() - t1;
  return have;
}

// is path position `pos` the end (exclusive boundary) of some node?
bool boundary_end(const Aligner &A, int pid, int64_t pos) {
  if (pos == A.plen(pid)) return true;
  const int64_t *o = A.offs(pid);
  int64_t n = A.n_nodes(pid);
  int64_t lo = 0, hi = n;
  while (lo < hi) { int64_t m = (lo + hi) / 2; if (o[m] <= pos) lo = m + 1; else hi = m; }
  return lo > 0 && o[lo - 1] == pos;
}

// node index containing path position pos (bisect_right(offsets,pos)-1)
int64_t node_at(const Aligner &A, int pid, int64_t pos) {
  const int64_t *o = A.offs(pid);
  int64_t n = A.n_nodes(pid);
  int64_t lo = 0, hi = n;
  while (lo < hi) { int64_t m = (lo + hi) / 2; if (o[m] <= pos) lo = m + 1; else hi = m; }
  return lo - 1;
}

constexpr int64_t MAX_INDEL = 16;
constexpr int GAP_OPEN = 6;
constexpr int GAP_EXTEND = 2;

// same-path small-diagonal-shift merge: an indel, not a junction
bool indel_join(const Aligner &A, const char *read, const Piece &first,
                const Piece &second, Piece &o1, Piece &o2, Gap &gap) {
  if (second.path != first.path) return false;
  int64_t diag1 = first.pstart - first.qstart;
  int64_t diag2 = second.pstart - second.qstart;
  int64_t g = diag2 - diag1;
  if (g == 0 || g > MAX_INDEL || g < -MAX_INDEL) return false;
  const char *ps = A.pseq(first.path);
  int64_t ins = g < 0 ? -g : 0;
  int64_t lo = std::max(first.qstart + 1, second.qstart - ins);
  int64_t hi = std::min(first.qend, second.qend - ins - 1);
  if (hi < lo) return false;
  int64_t best_c = -1, best_m = -1;
  for (int64_t c = lo; c <= hi; ++c) {
    int64_t m = 0;
    for (int64_t i = first.qstart; i < c; ++i)
      if (read[i] == ps[diag1 + i]) ++m;
    for (int64_t i = c + ins; i < second.qend; ++i)
      if (read[i] == ps[diag2 + i]) ++m;
    if (m > best_m) { best_m = m; best_c = c; }
  }
  if (best_c < 0) return false;
  int64_t c = best_c;
  o1.path = first.path;
  o1.qstart = first.qstart;
  o1.qend = c;
  o1.pstart = diag1 + first.qstart;
  o1.pend = diag1 + c;
  o1.mism = 0;
  for (int64_t i = o1.qstart; i < c; ++i)
    if (read[i] != ps[diag1 + i]) ++o1.mism;
  o2.path = second.path;
  o2.qstart = c + ins;
  o2.qend = second.qend;
  o2.pstart = diag2 + c + ins;
  o2.pend = diag2 + second.qend;
  o2.mism = 0;
  for (int64_t i = o2.qstart; i < o2.qend; ++i)
    if (read[i] != ps[diag2 + i]) ++o2.mism;
  gap.payload.clear();
  if (g > 0) {
    gap.kind = 1;
    for (int64_t i = diag1 + c; i < diag1 + c + g; ++i)
      gap.payload += (char)tolower(ps[i]);
  } else {
    gap.kind = 2;
    for (int64_t i = c; i < c + ins; ++i)
      gap.payload += (char)tolower(read[i]);
  }
  return true;
}

bool snap_join(const Aligner &A, const char *read, const Piece &first,
               const Piece &second, Piece &out1, Piece &out2) {
  int64_t diag1 = first.pstart - first.qstart;
  int64_t diag2 = second.pstart - second.qstart;
  int64_t lo = std::max(second.qstart, first.qstart + 1);
  int64_t hi = std::min(first.qend, second.qend - 1);
  for (int64_t c = lo; c <= hi; ++c) {
    int64_t pe1 = diag1 + c;
    int64_t ps2 = diag2 + c;
    if (pe1 <= first.pstart || !boundary_end(A, first.path, pe1)) continue;
    int64_t i2 = node_at(A, second.path, ps2);
    if (i2 < 0 || A.offs(second.path)[i2] != ps2 || ps2 >= A.plen(second.path))
      continue;
    int64_t i1 = node_at(A, first.path, pe1 - 1);
    if (A.ids(first.path)[i1] >= A.ids(second.path)[i2]) continue;
    // trim pieces to the split
    const char *s1 = A.pseq(first.path);
    const char *s2 = A.pseq(second.path);
    out1 = first;
    out1.qend = c;
    out1.pend = diag1 + c;
    out1.mism = 0;
    for (int64_t i = out1.qstart; i < c; ++i)
      if (read[i] != s1[diag1 + i]) ++out1.mism;
    out2 = second;
    out2.qstart = c;
    out2.pstart = diag2 + c;
    out2.mism = 0;
    for (int64_t i = c; i < out2.qend; ++i)
      if (read[i] != s2[diag2 + i]) ++out2.mism;
    return true;
  }
  return false;
}

// append cs ops for a piece, merging an adjacent ':' run at the boundary
void cs_piece(const Aligner &A, const char *read, const Piece &p,
              std::string &cs, int64_t &pending_run) {
  const char *ps = A.pseq(p.path);
  int64_t diag = p.pstart - p.qstart;
  int64_t run = pending_run;
  pending_run = 0;
  char buf[32];
  for (int64_t i = p.qstart; i < p.qend; ++i) {
    if (read[i] == ps[diag + i]) {
      ++run;
    } else {
      if (run) { snprintf(buf, sizeof buf, ":%lld", (long long)run); cs += buf; run = 0; }
      cs += '*';
      cs += (char)tolower(ps[diag + i]);
      cs += (char)tolower(read[i]);
    }
  }
  pending_run = run;  // may merge with next piece's leading run
}

// candidate score: matched - 3*mism - gap_cost (== span - 4*mism gapless,
// matching the Python SplicedAlignment.score())
int64_t cand_score(const Piece *cand, int n, const Gap &gap) {
  int64_t matched = 0, mism = 0;
  for (int i = 0; i < n; ++i) {
    matched += cand[i].span() - cand[i].mism;
    mism += cand[i].mism;
  }
  int64_t gap_cost =
      gap.kind ? GAP_OPEN + GAP_EXTEND * (int64_t)gap.payload.size() : 0;
  return matched - 3 * mism - gap_cost;
}

// second-best-gap MAPQ (integer arithmetic shared with mapper.py)
int mapq_from_scores(int64_t s1, int64_t s2) {
  if (s2 <= 0) return 60;
  if (s1 <= s2 || s1 <= 0) return 0;
  int64_t q = (40 * (s1 - s2)) / s1;
  return q > 60 ? 60 : (int)q;
}

// strand loop + two-piece rescue; returns piece count (0 = unmapped)
int align_core(Aligner &A, const char *read_in, int64_t L, Piece *best,
               bool &best_rev, Gap &best_gap, int &mapq_out, std::string &fwd,
               std::string &rev, std::vector<Vote> &scratch, Phases *ph) {
  ph->ns[7]++;
  fwd.assign(read_in, L);
  rev.resize(L);
  for (int64_t i = 0; i < L; ++i) rev[i] = comp(read_in[L - 1 - i]);

  int best_n = 0;
  best_rev = false;
  best_gap = Gap();
  bool have = false;
  int64_t best_score = 0;
  std::vector<Cand> strand_cands[2];
  mapq_out = 60;

  for (int strand = 0; strand < 2; ++strand) {
    const char *seq = strand ? rev.c_str() : fwd.c_str();
    Piece p1;
    if (!best_piece(A, seq, L, 0, L, false, 0, 0, p1, scratch, ph,
                    &strand_cands[strand]))
      continue;
    Piece cand[2] = {p1, Piece()};
    int cand_n = 1;
    Gap cand_gap;

    int64_t excl_diag = p1.pstart - p1.qstart;
    if (L - p1.qend >= A.k) {
      Piece p2;
      if (best_piece(A, seq, L, std::max((int64_t)0, p1.qend - 8), L, true,
                     p1.path, excl_diag, p2, scratch, ph) &&
          p2.qend > p1.qend) {
        int64_t tj = now_ns();
        Piece o1, o2;
        if (snap_join(A, seq, p1, p2, o1, o2)) {
          cand[0] = o1;
          cand[1] = o2;
          cand_n = 2;
        } else if (indel_join(A, seq, p1, p2, o1, o2, cand_gap)) {
          cand[0] = o1;
          cand[1] = o2;
          cand_n = 2;
        }
        ph->ns[2] += now_ns() - tj;
      }
    }
    if (cand_n == 1 && cand[0].qstart >= A.k) {
      Piece p0;
      if (best_piece(A, seq, L, 0, std::min(L, p1.qstart + 8), true, p1.path,
                     excl_diag, p0, scratch, ph) &&
          p0.qstart < p1.qstart) {
        int64_t tj = now_ns();
        Piece o1, o2;
        if (snap_join(A, seq, p0, p1, o1, o2)) {
          cand[0] = o1;
          cand[1] = o2;
          cand_n = 2;
        } else if (indel_join(A, seq, p0, p1, o1, o2, cand_gap)) {
          cand[0] = o1;
          cand[1] = o2;
          cand_n = 2;
        }
        ph->ns[2] += now_ns() - tj;
      }
    }

    // python span check: merged indel alignment spans pstart1..pend2
    int64_t span;
    if (cand_gap.kind) {
      span = cand[1].pend - cand[0].pstart;
    } else {
      span = 0;
      for (int i = 0; i < cand_n; ++i) span += cand[i].span();
    }
    if (span < L / 2) continue;
    int64_t score = cand_score(cand, cand_n, cand_gap);
    if (!have || score > best_score) {
      have = true;
      best_score = score;
      best_n = cand_n;
      best_rev = strand == 1;
      best_gap = cand_gap;
      best[0] = cand[0];
      if (cand_n > 1) best[1] = cand[1];
    }
  }
  if (!have) return 0;
  // MAPQ: best score among distinct placements (disjoint node-id interval
  // or opposite strand) vs the winner's final score
  int64_t tm = now_ns();
  int64_t w_lo = 0, w_hi = 0;
  for (int i = 0; i < best_n; ++i) {
    int64_t lo, hi;
    node_interval(A, best[i], lo, hi);
    if (i == 0) { w_lo = lo; w_hi = hi; }
    else { w_lo = std::min(w_lo, lo); w_hi = std::max(w_hi, hi); }
  }
  int64_t s2 = 0;
  for (int strand = 0; strand < 2; ++strand) {
    bool other_strand = (strand == 1) != best_rev;
    for (const Cand &c : strand_cands[strand])
      if (other_strand || c.hi < w_lo || c.lo > w_hi)
        s2 = std::max(s2, c.score);
  }
  mapq_out = mapq_from_scores(best_score, s2);
  ph->ns[3] += now_ns() - tm;
  return best_n;
}

// build the (possibly reverse-oriented) cs string for the chosen pieces
void build_cs(Aligner &A, const char *seq, const Piece *best, int best_n,
              bool best_rev, const Gap &gap, std::string &cs,
              int64_t &mism_total) {
  cs.clear();
  int64_t pending = 0;
  mism_total = 0;
  char buf[32];
  for (int i = 0; i < best_n; ++i) {
    cs_piece(A, seq, best[i], cs, pending);
    mism_total += best[i].mism;
    if (i == 0 && gap.kind) {
      if (pending) {
        snprintf(buf, sizeof buf, ":%lld", (long long)pending);
        cs += buf;
        pending = 0;
      }
      cs += gap.kind == 1 ? '-' : '+';
      cs += gap.payload;
    }
  }
  if (pending) {
    snprintf(buf, sizeof buf, ":%lld", (long long)pending);
    cs += buf;
  }
  if (best_rev) {
    std::string rcs;
    rcs.reserve(cs.size());
    std::vector<std::pair<int64_t, int64_t>> toks;
    auto is_opchar = [](char c) {
      return c == ':' || c == '*' || c == '-' || c == '+';
    };
    for (int64_t s = 0; s < (int64_t)cs.size();) {
      int64_t e = s + 1;
      while (e < (int64_t)cs.size() && !is_opchar(cs[e])) ++e;
      toks.push_back({s, e - s});
      s = e;
    }
    for (auto it = toks.rbegin(); it != toks.rend(); ++it) {
      char op = cs[it->first];
      if (op == ':') {
        rcs.append(cs, it->first, it->second);
      } else if (op == '*') {
        rcs += '*';
        rcs += comp(cs[it->first + 1]);
        rcs += comp(cs[it->first + 2]);
      } else {
        // '-'/'+' payload reverse-complements wholesale
        rcs += op;
        for (int64_t j = it->first + it->second - 1; j > it->first; --j)
          rcs += comp(cs[j]);
      }
    }
    cs.swap(rcs);
  }
}

// Python float-repr for the dv value produced by round(x, 6)
void format_dv(double x, char *buf, size_t cap) {
  double f = nearbyint(x * 1e6);
  if (f == 0) {
    snprintf(buf, cap, "0.0");
  } else {
    snprintf(buf, cap, "%g", f / 1e6);
  }
}

// full GAF record for one aligned read (parity with mapper.format_gaf);
// a gap alignment reports ONE contiguous walk interval like the Python
// formatter receives
void gaf_line(Aligner &A, const char *name, int64_t name_len, int64_t L,
              const Piece *best_in, int best_n_in, bool best_rev,
              const Gap &gap, const std::string &cs, int64_t mism_total,
              int mapq, std::string &out) {
  Piece merged;
  const Piece *best = best_in;
  int best_n = best_n_in;
  if (gap.kind) {
    merged = best_in[0];
    merged.qend = best_in[1].qend;
    merged.pend = best_in[1].pend;
    merged.mism = best_in[0].mism + best_in[1].mism;
    best = &merged;
    best_n = 1;
  }
  int64_t walk_len = 0, head_start = 0, tail_uncovered = 0, span = 0;
  // collect walk node ids (forward order)
  std::vector<int64_t> walk;
  for (int i = 0; i < best_n; ++i) {
    const Piece &p = best[i];
    int64_t i0 = node_at(A, p.path, p.pstart);
    int64_t i1 = node_at(A, p.path, p.pend - 1);
    const int64_t *o = A.offs(p.path);
    int64_t n_nodes = A.n_nodes(p.path);
    int64_t end_off = (i1 + 1 < n_nodes) ? o[i1 + 1] : A.plen(p.path);
    if (i == 0) head_start = p.pstart - o[i0];
    if (i == best_n - 1) tail_uncovered = end_off - p.pend;
    walk_len += end_off - o[i0];
    span += p.span();
    const int64_t *ids = A.ids(p.path);
    for (int64_t j = i0; j <= i1; ++j) walk.push_back(ids[j]);
  }
  int64_t pstart = best_rev ? tail_uncovered : head_start;
  int64_t pend_excl = best_rev ? walk_len - head_start : walk_len - tail_uncovered;
  // with a deletion gap, span (single interval) includes the deleted path
  // bases; matched bases exclude them (python: span - matched)
  int64_t matched_only = mism_total;  // param carries span-matched for gap case
  int64_t matches = span - matched_only;
  char dv[32];
  format_dv(span ? 1.0 - (double)matches / (double)span : 1.0, dv, sizeof dv);

  out.append(name, name_len);
  char buf[160];
  snprintf(buf, sizeof buf, "\t%lld\t%lld\t%lld\t+\t", (long long)L,
           (long long)best[0].qstart, (long long)best[best_n - 1].qend);
  out += buf;
  if (!best_rev) {
    for (int64_t id : walk) {
      snprintf(buf, sizeof buf, ">%lld", (long long)id);
      out += buf;
    }
  } else {
    for (auto it = walk.rbegin(); it != walk.rend(); ++it) {
      snprintf(buf, sizeof buf, "<%lld", (long long)*it);
      out += buf;
    }
  }
  snprintf(buf, sizeof buf, "\t%lld\t%lld\t%lld\t%lld\t%lld\t%d\tAS:i:%lld\tdv:f:%s\tcs:Z:",
           (long long)walk_len, (long long)pstart, (long long)(pend_excl - 1),
           (long long)matches, (long long)span, mapq, (long long)matches, dv);
  out += buf;
  out += cs;
  out += '\n';
}

struct FqRecord {
  std::string name;
  std::string seq;
  std::string qual;
  std::string raw;  // the 4 original lines (prefilter re-emits verbatim)
};

// count per-gene k-mer hits of one read; returns (#valid kmer windows),
// fills best_gene/best_count. Bases with phred < qthr (or non-ACGT) break
// the rolling window — the shark -q semantics (low-quality bases cannot
// confirm a gene).
int64_t kmer_hits(const Aligner &A, const char *seq, const char *qual,
                  int64_t L, int qthr, std::vector<int32_t> &counts,
                  std::vector<int64_t> &stamp, std::vector<int> &touched,
                  int64_t &window_counter, int &best_gene,
                  int64_t &best_count) {
  const int k = A.k;
  const uint64_t mask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  uint64_t packed = 0;
  int run = 0;
  int64_t valid = 0;
  touched.clear();
  for (int64_t i = 0; i < L; ++i) {
    int c = code(seq[i]);
    bool lowq = qual && qual[i] != 0 && (qual[i] - 33) < qthr;
    if (c < 0 || lowq) {
      run = 0;
      continue;
    }
    packed = ((packed << 2) | (uint64_t)c) & mask;
    if (++run < k) continue;
    ++valid;
    const int64_t pos_id = ++window_counter;
    // binary range search over the sorted index
    int64_t lo = 0, hi = A.n_kmers;
    while (lo < hi) { int64_t m = (lo + hi) / 2; if (A.kmers[m] < packed) lo = m + 1; else hi = m; }
    int64_t lo2 = lo; hi = A.n_kmers;
    while (lo2 < hi) { int64_t m = (lo2 + hi) / 2; if (A.kmers[m] <= packed) lo2 = m + 1; else hi = m; }
    if (lo2 - lo > A.max_hits) continue;
    for (int64_t t = lo; t < lo2; ++t) {
      int pid = A.pids[t];
      if (stamp[pid] == pos_id) continue;  // one vote per window per gene
      stamp[pid] = pos_id;
      if (counts[pid] == 0) touched.push_back(pid);
      ++counts[pid];
    }
  }
  best_gene = -1;
  best_count = 0;
  for (int pid : touched) {
    // ties prefer the lower gene id (parity with the python engine)
    if (counts[pid] > best_count ||
        (counts[pid] == best_count && best_gene >= 0 && pid < best_gene)) {
      best_count = counts[pid];
      best_gene = pid;
    }
    counts[pid] = 0;  // reset for the next read
  }
  return valid;
}

bool read_fastq_record(FILE *fp, FqRecord &rec, bool keep_raw = false) {
  // unbounded line reads (long-read FASTQs exceed any fixed buffer)
  static thread_local std::string line;
  if (keep_raw) rec.raw.clear();
  auto getl = [&](std::string *dst) -> bool {
    line.clear();
    char buf[1 << 16];
    for (;;) {
      if (!fgets(buf, sizeof buf, fp)) return !line.empty();
      line += buf;
      if (!line.empty() && line.back() == '\n') break;
    }
    size_t n = line.size();
    while (n && (line[n - 1] == '\n' || line[n - 1] == '\r')) --n;
    if (dst) dst->assign(line.data(), n);
    if (keep_raw) {
      rec.raw += line;
      if (rec.raw.empty() || rec.raw.back() != '\n') rec.raw += '\n';
    }
    return true;
  };
  std::string header;
  if (!getl(&header)) return false;
  if (!getl(&rec.seq)) return false;
  if (!getl(nullptr)) return false;
  if (!getl(&rec.qual)) return false;
  size_t sp = header.find_first_of(" \t");
  rec.name = header.substr(1, sp == std::string::npos ? std::string::npos : sp - 1);
  return true;
}

}  // namespace

extern "C" {

void *aln_create(const char *seqs, const int64_t *seq_off,
                 const int64_t *node_off, const int64_t *node_idx,
                 const int64_t *node_ids, int n_paths, const uint64_t *kmers,
                 const int32_t *pids, const int32_t *poss, int64_t n_kmers,
                 int k, int max_hits) {
  Aligner *A = new Aligner();
  A->seqs = seqs;
  A->seq_off = seq_off;
  A->node_off = node_off;
  A->node_idx = node_idx;
  A->node_ids = node_ids;
  A->n_paths = n_paths;
  A->kmers = kmers;
  A->pids = pids;
  A->poss = poss;
  A->n_kmers = n_kmers;
  A->k = k;
  A->max_hits = max_hits;
  // size the directory to ~n/32 buckets, clamped to the key width and to
  // 2^24 (128 MB of int64 offsets at the cap)
  int bits = 1;
  while ((int64_t(1) << bits) * 32 < n_kmers && bits < 24) ++bits;
  if (bits > 2 * k) bits = 2 * k;
  A->bucket_shift = 2 * k - bits;
  int64_t nb = int64_t(1) << bits;
  A->bucket.assign(nb + 1, 0);
  for (int64_t i = 0; i < n_kmers; ++i)
    A->bucket[(kmers[i] >> A->bucket_shift) + 1]++;
  for (int64_t b = 0; b < nb; ++b) A->bucket[b + 1] += A->bucket[b];
  return A;
}

void aln_destroy(void *h) { delete (Aligner *)h; }

// Returns number of pieces (0 = unmapped).
// out_meta: [reverse, qstart, qend, mism_total, mapq] (caller provides >=5)
// out_pieces: per piece [path, pstart, pend, qstart, qend]
// cs_buf: oriented cs string (NUL-terminated)
int aln_align(void *h, const char *read_in, int64_t L, int64_t *out_meta,
              int64_t *out_pieces, char *cs_buf, int64_t cs_cap) {
  Aligner &A = *(Aligner *)h;
  Piece best[2];
  bool best_rev;
  Gap gap;
  int mapq;
  Phases scratch_ph;  // merged into A.phases below (the per-read API
                      // must feed aln_phase_stats like map_file does)
  std::string fwd, rev;
  std::vector<Vote> scratch;
  int best_n =
      align_core(A, read_in, L, best, best_rev, gap, mapq, fwd, rev, scratch,
                 &scratch_ph);
  {
    std::lock_guard<std::mutex> g(A.phases_mu);
    A.phases.add(scratch_ph);
  }
  if (best_n == 0) return 0;

  const char *seq = best_rev ? rev.c_str() : fwd.c_str();
  std::string cs;
  int64_t mism_total;
  build_cs(A, seq, best, best_n, best_rev, gap, cs, mism_total);
  if ((int64_t)cs.size() + 1 > cs_cap) return -1;
  memcpy(cs_buf, cs.data(), cs.size());
  cs_buf[cs.size()] = 0;

  out_meta[0] = best_rev ? 1 : 0;
  out_meta[1] = best[0].qstart;
  out_meta[2] = best[best_n - 1].qend;
  out_meta[4] = mapq;
  if (gap.kind) {
    // report ONE merged interval; meta[3] = span - matched so the shared
    // formatter recovers matched correctly (deleted bases are in the span)
    int64_t matched =
        (best[0].span() - best[0].mism) + (best[1].span() - best[1].mism);
    int64_t span = best[1].pend - best[0].pstart;
    out_meta[3] = span - matched;
    out_pieces[0] = best[0].path;
    out_pieces[1] = best[0].pstart;
    out_pieces[2] = best[1].pend;
    out_pieces[3] = best[0].qstart;
    out_pieces[4] = best[1].qend;
    return 1;
  }
  out_meta[3] = mism_total;
  for (int i = 0; i < best_n; ++i) {
    out_pieces[i * 5 + 0] = best[i].path;
    out_pieces[i * 5 + 1] = best[i].pstart;
    out_pieces[i * 5 + 2] = best[i].pend;
    out_pieces[i * 5 + 3] = best[i].qstart;
    out_pieces[i * 5 + 4] = best[i].qend;
  }
  return best_n;
}

// Batch pipeline: FASTQ file(s) -> GAF on out_fd, optional threads.
// stats: [mapped, spliced, total]. Output order matches serial processing.
int64_t aln_map_file(void *h, const char *fq1, const char *fq2, int out_fd,
                     int n_threads, int64_t *stats) {
  Aligner &A = *(Aligner *)h;
  FILE *out = fdopen(dup(out_fd), "wb");
  if (!out) return -2;
  if (n_threads < 1) n_threads = 1;

  int64_t mapped = 0, spliced = 0, total = 0;
  const size_t CHUNK = 65536;
  std::vector<FqRecord> reads;
  std::vector<std::string> lines;

  const char *files[2] = {fq1, fq2};
  for (int fi = 0; fi < 2; ++fi) {
    if (!files[fi] || !files[fi][0]) continue;
    FILE *fp = fopen(files[fi], "rb");
    if (!fp) {
      fclose(out);
      return -1;
    }
    bool eof = false;
    while (!eof) {
      int64_t tio = now_ns();
      reads.clear();
      reads.reserve(CHUNK);
      FqRecord rec;
      while (reads.size() < CHUNK) {
        if (!read_fastq_record(fp, rec)) {
          eof = true;
          break;
        }
        reads.push_back(std::move(rec));
      }
      A.phases.ns[5] += now_ns() - tio;
      if (reads.empty()) break;
      lines.assign(reads.size(), std::string());
      std::vector<int64_t> t_mapped(n_threads, 0), t_spliced(n_threads, 0);

      std::vector<Phases> t_phases(n_threads);
      auto work = [&](int t) {
        Piece best[2];
        bool rev_flag;
        Gap gap;
        int mapq;
        std::string fwd, rev, cs;
        std::vector<Vote> scratch;
        char buf[96];
        Phases *ph = &t_phases[t];
        for (size_t i = t; i < reads.size(); i += n_threads) {
          const FqRecord &r = reads[i];
          int n = align_core(A, r.seq.data(), (int64_t)r.seq.size(), best,
                             rev_flag, gap, mapq, fwd, rev, scratch, ph);
          if (n == 0) {
            snprintf(buf, sizeof buf, "\t%lld\t0\t0\t+\t*\t0\t0\t0\t0\t0\t0\n",
                     (long long)r.seq.size());
            lines[i] = r.name + buf;
            continue;
          }
          t_mapped[t]++;
          if (n > 1 && !gap.kind) t_spliced[t]++;
          const char *seq = rev_flag ? rev.c_str() : fwd.c_str();
          int64_t tf = now_ns();
          int64_t mism_total;
          build_cs(A, seq, best, n, rev_flag, gap, cs, mism_total);
          int64_t meta3;
          if (gap.kind) {
            int64_t matched = (best[0].span() - best[0].mism) +
                              (best[1].span() - best[1].mism);
            meta3 = (best[1].pend - best[0].pstart) - matched;
          } else {
            meta3 = mism_total;
          }
          lines[i].clear();
          gaf_line(A, r.name.c_str(), (int64_t)r.name.size(),
                   (int64_t)r.seq.size(), best, n, rev_flag, gap, cs, meta3,
                   mapq, lines[i]);
          ph->ns[4] += now_ns() - tf;
        }
      };
      if (n_threads == 1) {
        work(0);
      } else {
        std::vector<std::thread> ths;
        for (int t = 0; t < n_threads; ++t) ths.emplace_back(work, t);
        for (auto &th : ths) th.join();
      }
      for (int t = 0; t < n_threads; ++t) {
        mapped += t_mapped[t];
        spliced += t_spliced[t];
      }
      total += (int64_t)reads.size();
      {
        std::lock_guard<std::mutex> g(A.phases_mu);
        for (int t = 0; t < n_threads; ++t) A.phases.add(t_phases[t]);
      }
      int64_t tw = now_ns();
      for (auto &l : lines) fwrite(l.data(), 1, l.size(), out);
      A.phases.ns[5] += now_ns() - tw;
      if (ferror(out)) {
        fclose(fp);
        fclose(out);
        return -3;
      }
    }
    fclose(fp);
  }
  if (fclose(out) != 0) return -3;
  stats[0] = mapped;
  stats[1] = spliced;
  stats[2] = total;
  return 0;
}

// shark-style gene-panel read prefilter (reference
// exps/3-homo-real/workflow/rules/pantas.smk:57-75 runs the external
// `shark -q 10 -r genes.fa -1 .. -2 ..`): keep a read pair when either
// mate's valid k-mer windows vote >= min_frac for one gene; emit the kept
// pairs verbatim plus a "name<TAB>gene" association TSV.
// gene_names: concatenated names; name_off: n_paths+1 offsets.
// stats: [kept_pairs, total_pairs]. Deterministic under threads.
int64_t shk_filter_file(void *h, const char *fq1, const char *fq2,
                        int out1_fd, int out2_fd, int tsv_fd,
                        const char *gene_names, const int64_t *name_off,
                        int qthr, double min_frac, int n_threads,
                        int64_t *stats) {
  Aligner &A = *(Aligner *)h;
  if (n_threads < 1) n_threads = 1;
  FILE *out1 = fdopen(dup(out1_fd), "wb");
  FILE *out2 = fq2 && fq2[0] ? fdopen(dup(out2_fd), "wb") : NULL;
  FILE *tsv = fdopen(dup(tsv_fd), "wb");
  FILE *fp1 = fopen(fq1, "rb");
  FILE *fp2 = fq2 && fq2[0] ? fopen(fq2, "rb") : NULL;
  if (!out1 || !tsv || !fp1 || (fq2 && fq2[0] && (!out2 || !fp2))) {
    if (out1) fclose(out1);
    if (out2) fclose(out2);
    if (tsv) fclose(tsv);
    if (fp1) fclose(fp1);
    if (fp2) fclose(fp2);
    return -1;
  }

  int64_t kept = 0, total = 0;
  const size_t CHUNK = 16384;
  std::vector<FqRecord> r1s, r2s;
  std::vector<int> genes;       // winning gene per pair (-1 = drop)
  bool eof = false;
  while (!eof) {
    r1s.clear();
    r2s.clear();
    FqRecord rec;
    while (r1s.size() < CHUNK) {
      if (!read_fastq_record(fp1, rec, true)) {
        eof = true;
        break;
      }
      r1s.push_back(rec);
      if (fp2) {
        if (!read_fastq_record(fp2, rec, true)) {
          eof = true;  // ragged pair input: stop at the shorter file
          r1s.pop_back();
          break;
        }
        r2s.push_back(rec);
      }
    }
    if (r1s.empty()) break;
    genes.assign(r1s.size(), -1);

    auto work = [&](int t) {
      std::vector<int32_t> counts(A.n_paths, 0);
      std::vector<int64_t> stamp(A.n_paths, 0);
      std::vector<int> touched;
      int64_t wc = 0;
      for (size_t i = t; i < r1s.size(); i += n_threads) {
        int bg = -1;
        int64_t bc = 0;
        int best_gene = -1;
        double best_frac = 0.0;
        const FqRecord *mates[2] = {&r1s[i], fp2 ? &r2s[i] : NULL};
        for (int m = 0; m < 2; ++m) {
          if (!mates[m]) continue;
          const FqRecord &r = *mates[m];
          const char *q = r.qual.size() == r.seq.size() ? r.qual.data() : NULL;
          int64_t valid = kmer_hits(A, r.seq.data(), q, (int64_t)r.seq.size(),
                                    qthr, counts, stamp, touched, wc, bg, bc);
          if (valid <= 0 || bg < 0) continue;
          double frac = (double)bc / (double)valid;
          if (frac >= min_frac && frac > best_frac) {
            best_frac = frac;
            best_gene = bg;
          }
        }
        genes[i] = best_gene;
      }
    };
    if (n_threads == 1) {
      work(0);
    } else {
      std::vector<std::thread> ths;
      for (int t = 0; t < n_threads; ++t) ths.emplace_back(work, t);
      for (auto &th : ths) th.join();
    }

    for (size_t i = 0; i < r1s.size(); ++i) {
      ++total;
      if (genes[i] < 0) continue;
      ++kept;
      fwrite(r1s[i].raw.data(), 1, r1s[i].raw.size(), out1);
      if (out2) fwrite(r2s[i].raw.data(), 1, r2s[i].raw.size(), out2);
      const char *gn = gene_names + name_off[genes[i]];
      size_t gl = (size_t)(name_off[genes[i] + 1] - name_off[genes[i]]);
      fwrite(r1s[i].name.data(), 1, r1s[i].name.size(), tsv);
      fputc('\t', tsv);
      fwrite(gn, 1, gl, tsv);
      fputc('\n', tsv);
    }
    if (ferror(out1) || (out2 && ferror(out2)) || ferror(tsv)) {
      fclose(fp1);
      if (fp2) fclose(fp2);
      fclose(out1);
      if (out2) fclose(out2);
      fclose(tsv);
      return -3;
    }
  }
  fclose(fp1);
  if (fp2) fclose(fp2);
  int rc = fclose(out1);
  rc |= out2 ? fclose(out2) : 0;
  rc |= fclose(tsv);
  if (rc != 0) return -3;
  stats[0] = kept;
  stats[1] = total;
  return 0;
}

// per-phase ns totals since aln_create: [seed, extend, join, mapq, format,
// io, best_piece_calls, reads] — see Phases
void aln_phase_stats(void *h, int64_t *out8) {
  Aligner &A = *(Aligner *)h;
  std::lock_guard<std::mutex> g(A.phases_mu);
  for (int i = 0; i < 8; ++i) out8[i] = A.phases.ns[i];
}

}  // extern "C"
