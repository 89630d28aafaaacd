// KubeTPU native allocator core — the schedule-latency hot loop (copied
// from kubegpu_tpu/allocator/csrc/allocator_core.cpp, with switched nodes
// added).
//
// Reference parity: the reference's hot loop was Go
// (grpalloc.PodFitsGroupConstraints, SURVEY.md §3/§4.2); KubeTPU's native
// equivalent is this C++ core behind a C ABI consumed via ctypes
// (kubegpu_tpu_torch/allocator/_native.py).  Semantics are bit-for-bit
// identical to the Python implementations in topology/slices.py
// (find_free_placements), topology/locality.py (+allocator/ordering.py:
// evaluate_order) and allocator/gang.py — tests/test_torch_native.py
// asserts parity on random cases, and equality with the reference's core
// on every TPU spec.
//
// A switched spec (an NVSwitch node, mesh.py TopologySpec.switched) lays
// its cards out as a line whose geometry only orders them: any two cards
// of one host are adjacent, two cards of different hosts never are
// (TpuTopology.are_ici_adjacent), and a card's neighbours are the other
// cards of its host (TpuTopology.neighbors).  Only the two entries that
// ask for adjacency take the flag (ktpu_eval_order, ktpu_connected_order);
// placement enumeration and the fragmentation score stay mesh-based on
// every spec, as slices.py's are.
//
// Layout conventions (shared with the Python side):
//   - mesh cells are indexed row-major, z fastest: idx = (x*my + y)*mz + z
//   - coords cross the ABI as flat int32 triples [x0,y0,z0, x1,y1,z1, ...]
//   - occupancy is a uint8 mask over cell indices (1 = blocked)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <utility>
#include <vector>

namespace {

struct MeshView {
  int mx, my, mz;
  bool wx, wy, wz;
  bool sw = false;         // switched: adjacency is one host's cards
  int hx = 1, hy = 1, hz = 1;  // host block

  int dim(int axis) const { return axis == 0 ? mx : (axis == 1 ? my : mz); }
  bool wrap(int axis) const { return axis == 0 ? wx : (axis == 1 ? wy : wz); }
  int cell(int x, int y, int z) const { return (x * my + y) * mz + z; }
  int ncells() const { return mx * my * mz; }

  // Torus manhattan distance honoring wraparound (mesh.py hop_distance):
  // wrap reduces an axis delta only when that axis wraps AND dim > 2.
  int hop(const int32_t* a, const int32_t* b) const {
    int d = 0;
    for (int axis = 0; axis < 3; ++axis) {
      int dm = dim(axis);
      int delta = a[axis] - b[axis];
      if (delta < 0) delta = -delta;
      if (wrap(axis) && dm > 2) {
        int other = dm - delta;
        if (other < delta) delta = other;
      }
      d += delta;
    }
    return d;
  }

  bool same_host(const int32_t* a, const int32_t* b) const {
    return a[0] / hx == b[0] / hx && a[1] / hy == b[1] / hy &&
           a[2] / hz == b[2] / hz;
  }

  // One link apart (mesh.py are_ici_adjacent): on a switched spec, two
  // distinct cards of one host — a pair of two hosts is not adjacent even
  // where its torus distance is 1; otherwise torus distance 1.
  bool adjacent(const int32_t* a, const int32_t* b) const {
    if (sw)
      return same_host(a, b) && (a[0] != b[0] || a[1] != b[1] || a[2] != b[2]);
    return hop(a, b) == 1;
  }
};

// 128-bit-ish key for a placement's coord-set, for wrapped-placement dedup
// (slices.py enumerate_placements canonicalizes duplicate coord-sets away).
// Meshes up to 512 cells are covered by 8x64 bits; bigger meshes fall back
// to hashing the sorted cell list.
struct SetKey {
  uint64_t w[8];
  bool operator==(const SetKey& o) const {
    return std::memcmp(w, o.w, sizeof(w)) == 0;
  }
};
struct SetKeyHash {
  size_t operator()(const SetKey& k) const {
    uint64_t h = 1469598103934665603ull;
    for (uint64_t v : k.w) {
      h ^= v;
      h *= 1099511628211ull;
    }
    return (size_t)h;
  }
};

// Shared fragmentation heuristic: fraction of the placement's boundary
// (neighbor slots outside it) that is off-mesh or occupied.  `inplace`
// is caller-provided scratch of m.ncells() bytes, containing the
// placement's membership mask on entry; left CLEARED on exit (so a
// ranking loop can reuse one buffer).  Both ktpu_fragmentation_score
// and the fused ktpu_rank_free_placements call this — the rule must
// exist exactly once.
static double frag_score_masked(const MeshView& m, const uint8_t* occupied,
                                const int32_t* coords, int32_t vol,
                                std::vector<uint8_t>& inplace) {
  for (int i = 0; i < vol; ++i) {
    const int32_t* c = coords + i * 3;
    inplace[m.cell(c[0], c[1], c[2])] = 1;
  }
  int64_t boundary = 0, blocked = 0;
  for (int i = 0; i < vol; ++i) {
    const int32_t* c = coords + i * 3;
    for (int axis = 0; axis < 3; ++axis) {
      const int dm = m.dim(axis);
      for (int delta = -1; delta <= 1; delta += 2) {
        int nc[3] = {c[0], c[1], c[2]};
        nc[axis] += delta;
        if (nc[axis] < 0 || nc[axis] >= dm) {
          if (m.wrap(axis) && dm > 2) {
            nc[axis] = ((nc[axis] % dm) + dm) % dm;
          } else {
            ++boundary;
            ++blocked;  // mesh wall counts as packed-against
            continue;
          }
        }
        const int cell = m.cell(nc[0], nc[1], nc[2]);
        if (inplace[cell]) continue;
        ++boundary;
        if (occupied[cell]) ++blocked;
      }
    }
  }
  for (int i = 0; i < vol; ++i) {
    const int32_t* c = coords + i * 3;
    inplace[m.cell(c[0], c[1], c[2])] = 0;
  }
  return boundary ? (double)blocked / (double)boundary : 1.0;
}

// Shared free-placement enumeration: origin order (ox→oy→oz, wrapped
// axes with dim>2 and size<dim contributing all origins), local
// row-major coords (dx outer, dz inner), SetKey dedup BEFORE the
// occupancy filter, stopping after `limit` free placements.  Both
// ktpu_find_free_placements and the fused ktpu_rank_free_placements
// enumerate through this — the order/dedup/limit rules must exist
// exactly once (they define cross-path parity).  `emit(ox, oy, oz,
// coords)` is called per free placement and returns false to abort.
// Returns 0, or -2 when the mesh exceeds the dedup key width, or -3
// when emit aborted.
template <typename F>
static int32_t for_each_free_placement(const MeshView& m,
                                       const uint8_t* occupied, int32_t sx,
                                       int32_t sy, int32_t sz,
                                       int32_t limit, F&& emit) {
  if (sx > m.mx || sy > m.my || sz > m.mz) return 0;
  if (m.ncells() > 512) return -2;  // key width exceeded

  auto origins = [&](int axis, int size) {
    int dm = m.dim(axis);
    int n = (m.wrap(axis) && dm > 2 && size < dm) ? dm : dm - size + 1;
    return n;
  };

  std::unordered_set<SetKey, SetKeyHash> seen;
  seen.reserve(256);
  const int vol = sx * sy * sz;
  std::vector<int32_t> coords(vol * 3);
  int nfree = 0;
  const int nox = origins(0, sx), noy = origins(1, sy), noz = origins(2, sz);
  for (int ox = 0; ox < nox; ++ox) {
    for (int oy = 0; oy < noy; ++oy) {
      for (int oz = 0; oz < noz; ++oz) {
        SetKey key{};
        bool free_ok = true;
        int k = 0;
        for (int dx = 0; dx < sx; ++dx) {
          int x = ox + dx;
          if (x >= m.mx) x -= m.mx;
          for (int dy = 0; dy < sy; ++dy) {
            int y = oy + dy;
            if (y >= m.my) y -= m.my;
            for (int dz = 0; dz < sz; ++dz) {
              int z = oz + dz;
              if (z >= m.mz) z -= m.mz;
              int c = m.cell(x, y, z);
              key.w[c >> 6] |= (1ull << (c & 63));
              if (occupied[c]) free_ok = false;
              coords[k++] = x;
              coords[k++] = y;
              coords[k++] = z;
            }
          }
        }
        if (!seen.insert(key).second) continue;
        if (!free_ok) continue;
        if (!emit(ox, oy, oz, coords.data())) return -3;
        ++nfree;
        if (limit > 0 && nfree >= limit) return 0;
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Enumerate free contiguous placements of shape (sx,sy,sz), honoring
// per-axis wraparound, skipping any placement touching an occupied cell,
// stopping after `limit` results (limit<=0 means unlimited).
//
// Origin enumeration order matches slices.py (_axis_origins nesting
// ox→oy→oz; wrapped axes with dim>2 and size<dim contribute all origins),
// and each placement's coords are emitted in local row-major order
// (dx outer, dz inner) — downstream worker ordering relies on this.
//
// out_origins: capacity >= limit*3 ints; out_coords: >= limit*vol*3 ints.
// Returns the number of placements written, or -1 if the caller's buffers
// would overflow (cap = max_out placements).
int32_t ktpu_find_free_placements(
    int32_t mx, int32_t my, int32_t mz, int32_t wx, int32_t wy, int32_t wz,
    const uint8_t* occupied, int32_t sx, int32_t sy, int32_t sz,
    int32_t limit, int32_t max_out, int32_t* out_origins,
    int32_t* out_coords) {
  MeshView m{mx, my, mz, wx != 0, wy != 0, wz != 0};
  const int vol = sx * sy * sz;
  int32_t nout = 0;
  int32_t rc = for_each_free_placement(
      m, occupied, sx, sy, sz, limit,
      [&](int ox, int oy, int oz, const int32_t* coords) {
        if (nout >= max_out) return false;  // caller buffer overflow
        out_origins[nout * 3 + 0] = ox;
        out_origins[nout * 3 + 1] = oy;
        out_origins[nout * 3 + 2] = oz;
        std::memcpy(out_coords + (size_t)nout * vol * 3, coords,
                    sizeof(int32_t) * vol * 3);
        ++nout;
        return true;
      });
  if (rc == -3) return -1;  // emit aborted = buffer overflow
  if (rc < 0) return rc;
  return nout;
}

// Weighted ICI locality of a logical device order under a workload's mesh
// axes — locality.py traffic_pairs_for_mesh_axes + ici_locality fused.
//
// order: n coord triples, logical-device order (last axis varies fastest).
// axis_sizes/axis_weights: n_axes parallel arrays; product(sizes) must be n.
// Every axis of size s contributes ring pairs (k, k+1 mod s) within each
// group varying only along that axis; s==2 contributes one pair per group.
// A pair counts as local iff it is one link apart (MeshView::adjacent:
// torus hop distance exactly 1, or on a switched spec (sw != 0) two cards
// of one host block (hx, hy, hz)).  Returns locality in [0,1]; 1.0 when
// no pairs.  Returns -1.0 on size mismatch.
double ktpu_eval_order(int32_t mx, int32_t my, int32_t mz, int32_t wx,
                       int32_t wy, int32_t wz, int32_t sw, int32_t hx,
                       int32_t hy, int32_t hz, const int32_t* order,
                       int32_t n, const int32_t* axis_sizes,
                       const double* axis_weights, int32_t n_axes) {
  if (hx <= 0 || hy <= 0 || hz <= 0) return -1.0;
  MeshView m{mx, my, mz, wx != 0, wy != 0, wz != 0, sw != 0, hx, hy, hz};
  int64_t total_chips = 1;
  for (int i = 0; i < n_axes; ++i) total_chips *= axis_sizes[i];
  if (total_chips != n) return -1.0;

  // strides for row-major logical indexing (last axis fastest)
  std::vector<int64_t> strides(n_axes, 1);
  for (int i = n_axes - 2; i >= 0; --i)
    strides[i] = strides[i + 1] * axis_sizes[i + 1];

  double total_w = 0.0, local_w = 0.0;
  for (int ax = 0; ax < n_axes; ++ax) {
    const int s = axis_sizes[ax];
    if (s <= 1) continue;
    const double w = axis_weights[ax];
    const int64_t stride = strides[ax];
    for (int64_t base = 0; base < n; ++base) {
      if ((base / stride) % s != 0) continue;
      const int upto = (s == 2) ? 1 : s;  // 2-ring has one unique pair
      for (int k = 0; k < upto; ++k) {
        const int32_t* a = order + (base + (int64_t)k * stride) * 3;
        const int32_t* b = order + (base + (int64_t)((k + 1) % s) * stride) * 3;
        if (a[0] == b[0] && a[1] == b[1] && a[2] == b[2]) continue;
        total_w += w;
        if (m.adjacent(a, b)) local_w += w;
      }
    }
  }
  return total_w == 0.0 ? 1.0 : local_w / total_w;
}

// Viterbi orientation chaining (gang.py _orient_rings): choose one
// orientation option per host block so each block's entry chip sits next
// to the previous block's exit chip; with `close`, also optimize the wrap
// transition (last block's exit → first block's entry), trying every
// option of block 0 as the start.  This is the measured hot loop of the
// schedule path (the p50-latency metric's inner kernel).
//
// opts_data: concatenated coord triples of every option of every block,
//   laid out block-major then option-major:
//   block0.opt0, block0.opt1, ..., block1.opt0, ...
// n_opts[b], opt_len[b]: option count / coords-per-option of block b.
// out_choice[b]: chosen option index per block.
// Tie-breaking matches the Python reference exactly: strict improvement,
// starts and options visited in index order.  Returns 0 on success.
int32_t ktpu_orient_rings(const int32_t* opts_data, const int32_t* n_opts,
                          const int32_t* opt_len, int32_t n_blocks,
                          int32_t close, int32_t* out_choice) {
  if (n_blocks <= 0) return -1;
  // per-block offsets into opts_data (in int32 units)
  std::vector<int64_t> block_off(n_blocks);
  int64_t off = 0;
  int max_opts = 0;
  for (int b = 0; b < n_blocks; ++b) {
    block_off[b] = off;
    off += (int64_t)n_opts[b] * opt_len[b] * 3;
    if (n_opts[b] > max_opts) max_opts = n_opts[b];
  }
  auto opt_ptr = [&](int b, int j) {
    return opts_data + block_off[b] + (int64_t)j * opt_len[b] * 3;
  };
  // entry coord of option = first triple; exit coord = last triple
  auto trans = [&](int pb, int pj, int nb, int nj) -> int64_t {
    const int32_t* prev = opt_ptr(pb, pj) + (opt_len[pb] - 1) * 3;  // exit
    const int32_t* nxt = opt_ptr(nb, nj);                           // entry
    int d = 0;
    for (int k = 0; k < 3; ++k) {
      int delta = prev[k] - nxt[k];
      d += delta < 0 ? -delta : delta;
    }
    return d == 1 ? 0 : d;
  };
  if (n_blocks == 1) {
    out_choice[0] = 0;
    return 0;
  }

  const int n_starts = close ? n_opts[0] : 1;
  std::vector<int64_t> cost(max_opts), ncost(max_opts);
  // back[i-1][j] = predecessor option at block i-1 for option j at block i
  std::vector<int32_t> back((size_t)(n_blocks - 1) * max_opts);
  std::vector<int32_t> best_path(n_blocks);
  int64_t best_total = -1;

  for (int start = 0; start < n_starts; ++start) {
    // block 0 is pinned to `start`
    int prev_count = 1;
    cost[0] = 0;
    for (int i = 1; i < n_blocks; ++i) {
      for (int j = 0; j < n_opts[i]; ++j) {
        int64_t bestc = -1;
        int32_t bestj = 0;
        for (int pj = 0; pj < prev_count; ++pj) {
          const int real_pj = (i == 1) ? start : pj;
          int64_t c = cost[pj] + trans(i - 1, real_pj, i, j);
          if (bestc < 0 || c < bestc) {
            bestc = c;
            bestj = pj;
          }
        }
        ncost[j] = bestc;
        back[(size_t)(i - 1) * max_opts + j] = bestj;
      }
      prev_count = n_opts[i];
      std::swap(cost, ncost);
    }
    for (int j = 0; j < n_opts[n_blocks - 1]; ++j) {
      int64_t total = cost[j];
      if (close) total += trans(n_blocks - 1, j, 0, start);
      if (best_total < 0 || total < best_total) {
        best_total = total;
        // backtrack
        int cur = j;
        for (int i = n_blocks - 1; i >= 1; --i) {
          best_path[i] = cur;
          cur = back[(size_t)(i - 1) * max_opts + cur];
        }
        best_path[0] = start;
      }
    }
  }
  for (int b = 0; b < n_blocks; ++b) out_choice[b] = best_path[b];
  return 0;
}

// Packing heuristic (slices.py fragmentation_score): fraction of the
// placement's boundary (neighbor slots outside it) that is off-mesh or
// occupied.  coords: vol triples; occupied mask as above.
double ktpu_fragmentation_score(int32_t mx, int32_t my, int32_t mz,
                                int32_t wx, int32_t wy, int32_t wz,
                                const uint8_t* occupied,
                                const int32_t* coords, int32_t vol) {
  MeshView m{mx, my, mz, wx != 0, wy != 0, wz != 0};
  std::vector<uint8_t> inplace(m.ncells(), 0);
  return frag_score_masked(m, occupied, coords, vol, inplace);
}

// Fused enumerate + fragmentation-rank (gang.py's per-shape candidate
// ranking): enumerate free placements exactly like
// ktpu_find_free_placements (same origin order, same dedup, stopping
// after `limit` free placements), score each with the
// ktpu_fragmentation_score heuristic inline, stable-sort by frag
// descending (ties keep enumeration order, matching Python's stable
// sort), and emit only the top `k`.  This keeps the ~limit×shapes
// placement objects and their per-placement marshalling out of Python —
// the scheduler only ever *scores* the top few per shape.
//
// out buffers sized for k placements.  Returns placements written,
// -1 on buffer overflow (never happens with k-sized buffers), -2 when
// the mesh exceeds the dedup key width (caller falls back to Python).
int32_t ktpu_rank_free_placements(
    int32_t mx, int32_t my, int32_t mz, int32_t wx, int32_t wy, int32_t wz,
    const uint8_t* occupied, int32_t sx, int32_t sy, int32_t sz,
    int32_t limit, int32_t k, int32_t* out_origins, int32_t* out_coords,
    double* out_frag) {
  MeshView m{mx, my, mz, wx != 0, wy != 0, wz != 0};
  const int vol = sx * sy * sz;
  struct Cand {
    double frag;
    std::vector<int32_t> coords;
    int32_t ox, oy, oz;
  };
  std::vector<Cand> cands;
  std::vector<uint8_t> inplace(m.ncells(), 0);
  int32_t rc = for_each_free_placement(
      m, occupied, sx, sy, sz, limit,
      [&](int ox, int oy, int oz, const int32_t* coords) {
        Cand cd;
        cd.frag = frag_score_masked(m, occupied, coords, vol, inplace);
        cd.coords.assign(coords, coords + vol * 3);
        cd.ox = ox;
        cd.oy = oy;
        cd.oz = oz;
        cands.push_back(std::move(cd));
        return true;
      });
  if (rc < 0) return rc;
  std::stable_sort(cands.begin(), cands.end(),
                   [](const Cand& a, const Cand& b) {
                     return a.frag > b.frag;
                   });
  int32_t nout = 0;
  for (const Cand& cd : cands) {
    if (nout >= k) break;
    out_origins[nout * 3 + 0] = cd.ox;
    out_origins[nout * 3 + 1] = cd.oy;
    out_origins[nout * 3 + 2] = cd.oz;
    std::memcpy(out_coords + (size_t)nout * vol * 3, cd.coords.data(),
                sizeof(int32_t) * vol * 3);
    out_frag[nout] = cd.frag;
    ++nout;
  }
  return nout;
}

// Viterbi ring alignment (gang.py _align_units): choose an orientation per
// ring so POSITION-WISE pairs between consecutive rings (and last→first)
// maximize unwrapped-ICI adjacency.  All rings share opt_len; unit 0's
// start is restricted to its first two variants (identity/reversal —
// global rotations preserve all pairwise gains).  Tie-breaking matches the
// Python reference exactly: strict >, first maximum wins, earlier start
// wins, option index order.
int32_t ktpu_align_units(const int32_t* opts_data, const int32_t* n_opts,
                         int32_t opt_len, int32_t n_units,
                         int32_t* out_choice) {
  if (n_units < 2 || opt_len <= 0) return -1;
  std::vector<int64_t> unit_off(n_units);
  int64_t off = 0;
  int max_opts = 0;
  for (int u = 0; u < n_units; ++u) {
    if (n_opts[u] <= 0) return -1;
    unit_off[u] = off;
    off += (int64_t)n_opts[u] * opt_len * 3;
    if (n_opts[u] > max_opts) max_opts = n_opts[u];
  }
  auto opt_ptr = [&](int u, int j) {
    return opts_data + unit_off[u] + (int64_t)j * opt_len * 3;
  };
  // positions i of rings a, b with |Δ| manhattan (no wrap) == 1
  auto gain = [&](const int32_t* a, const int32_t* b) -> int64_t {
    int64_t g = 0;
    for (int i = 0; i < opt_len; ++i) {
      const int32_t* p = a + (int64_t)i * 3;
      const int32_t* q = b + (int64_t)i * 3;
      int d = 0;
      for (int k = 0; k < 3; ++k) {
        int delta = p[k] - q[k];
        d += delta < 0 ? -delta : delta;
      }
      if (d == 1) ++g;
    }
    return g;
  };

  std::vector<int64_t> score(max_opts), nscore(max_opts);
  std::vector<int32_t> back((size_t)(n_units > 2 ? n_units - 2 : 0)
                            * max_opts);
  std::vector<int32_t> best_path(n_units);
  int64_t best_total = -1;
  const int n_starts = n_opts[0] < 2 ? n_opts[0] : 2;

  for (int start = 0; start < n_starts; ++start) {
    const int32_t* s0 = opt_ptr(0, start);
    for (int j = 0; j < n_opts[1]; ++j)
      score[j] = gain(s0, opt_ptr(1, j));
    for (int i = 2; i < n_units; ++i) {
      for (int j = 0; j < n_opts[i]; ++j) {
        int64_t bs = -1;
        int32_t bj = 0;
        for (int pj = 0; pj < n_opts[i - 1]; ++pj) {
          int64_t s = score[pj] + gain(opt_ptr(i - 1, pj), opt_ptr(i, j));
          if (s > bs) {
            bs = s;
            bj = pj;
          }
        }
        nscore[j] = bs;
        back[(size_t)(i - 2) * max_opts + j] = bj;
      }
      std::swap(score, nscore);
    }
    for (int j = 0; j < n_opts[n_units - 1]; ++j) {
      int64_t total = score[j] + gain(opt_ptr(n_units - 1, j), s0);
      if (total > best_total) {
        best_total = total;
        int cur = j;
        for (int i = n_units - 1; i >= 2; --i) {
          best_path[i] = cur;
          cur = back[(size_t)(i - 2) * max_opts + cur];
        }
        best_path[1] = cur;
        best_path[0] = start;
      }
    }
  }
  for (int u = 0; u < n_units; ++u) out_choice[u] = best_path[u];
  return 0;
}

// Connected-region fallback search (gang.py _connected_candidate): from
// each free coord in lexicographic order, grow a connected set of free
// chips with a sorted-frontier BFS (a min-heap keyed on coord — identical
// pop order to the Python heapq frontier), then chunk it
// host-locally (pods take chips_per_pod chips host by host, hosts in id
// order).  Returns 0 + the first start whose chunked order covers `total`
// chips in exactly `num_pods` chunks, 1 when no start works, -1 on bad
// args.  Host ids are row-major (z fastest) over the host-block grid,
// matching TpuTopology.build.  On a switched spec (sw != 0) a chip's
// neighbours are the other chips of its host block.
int32_t ktpu_connected_order(int32_t mx, int32_t my, int32_t mz, int32_t wx,
                             int32_t wy, int32_t wz, int32_t sw,
                             const uint8_t* blocked, int32_t hx, int32_t hy,
                             int32_t hz, int32_t total,
                             int32_t chips_per_pod, int32_t num_pods,
                             int32_t* out_order) {
  if (total <= 0 || chips_per_pod <= 0 || hx <= 0 || hy <= 0 || hz <= 0)
    return -1;
  MeshView m{mx, my, mz, wx != 0, wy != 0, wz != 0, sw != 0, hx, hy, hz};
  const int n = m.ncells();
  const int hosts_y = (my + hy - 1) / hy, hosts_z = (mz + hz - 1) / hz;
  auto host_of = [&](int x, int y, int z) {
    return ((x / hx) * hosts_y + y / hy) * hosts_z + z / hz;
  };
  // free cells in lexicographic coord order == ascending cell index
  // (cell = (x*my + y)*mz + z is monotone in (x, y, z))
  std::vector<int32_t> free_cells;
  free_cells.reserve(n);
  for (int i = 0; i < n; ++i)
    if (!blocked[i]) free_cells.push_back(i);
  if ((int)free_cells.size() < total) return 1;

  std::vector<uint8_t> seen(n);
  std::vector<int32_t> heap, region, order;
  auto decode = [&](int cell, int32_t* xyz) {
    xyz[2] = cell % mz;
    xyz[1] = (cell / mz) % my;
    xyz[0] = cell / (mz * my);
  };
  for (int32_t start : free_cells) {
    std::fill(seen.begin(), seen.end(), 0);
    heap.clear();
    region.clear();
    seen[start] = 1;
    heap.push_back(start);
    auto cmp = [](int32_t a, int32_t b) { return a > b; };  // min-heap
    while (!heap.empty()) {
      std::pop_heap(heap.begin(), heap.end(), cmp);
      int32_t cur = heap.back();
      heap.pop_back();
      region.push_back(cur);
      if ((int)region.size() >= total) break;
      int32_t c[3];
      decode(cur, c);
      auto visit = [&](int cell) {
        if (!seen[cell] && !blocked[cell]) {
          seen[cell] = 1;
          heap.push_back(cell);
          std::push_heap(heap.begin(), heap.end(), cmp);
        }
      };
      if (m.sw) {   // the other chips of cur's host block
        const int bx = c[0] - c[0] % hx, by = c[1] - c[1] % hy,
                  bz = c[2] - c[2] % hz;
        for (int x = bx; x < bx + hx; ++x)
          for (int y = by; y < by + hy; ++y)
            for (int z = bz; z < bz + hz; ++z) {
              const int cell = m.cell(x, y, z);
              if (cell != cur) visit(cell);
            }
        continue;
      }
      for (int axis = 0; axis < 3; ++axis) {
        const int dim = m.dim(axis);
        if (dim == 1) continue;
        for (int delta = -1; delta <= 1; delta += 2) {
          int32_t nb[3] = {c[0], c[1], c[2]};
          nb[axis] += delta;
          if (nb[axis] < 0 || nb[axis] >= dim) {
            if (!(m.wrap(axis) && dim > 2)) continue;
            nb[axis] = ((nb[axis] % dim) + dim) % dim;
          }
          visit(m.cell(nb[0], nb[1], nb[2]));
        }
      }
    }
    if ((int)region.size() < total) continue;
    // group by host id; region cells are in BFS order, so sort each
    // host's chips (cell order == coord order)
    std::vector<std::pair<int32_t, int32_t>> host_cell;  // (host, cell)
    host_cell.reserve(region.size());
    for (int32_t cell : region) {
      int32_t c[3];
      decode(cell, c);
      host_cell.emplace_back(host_of(c[0], c[1], c[2]), cell);
    }
    std::sort(host_cell.begin(), host_cell.end());
    order.clear();
    int chunks_formed = 0;
    for (size_t i = 0; i < host_cell.size() && (int)order.size() < total;) {
      size_t j = i;
      while (j < host_cell.size() && host_cell[j].first == host_cell[i].first)
        ++j;
      const int in_host = (int)(j - i);
      const int usable = (in_host / chips_per_pod) * chips_per_pod;
      int take = total - (int)order.size();
      if (usable < take) take = usable;
      for (int k = 0; k < take; ++k)
        order.push_back(host_cell[i + k].second);
      chunks_formed += take / chips_per_pod;
      i = j;
    }
    if ((int)order.size() != total || chunks_formed != num_pods) continue;
    for (int i = 0; i < total; ++i) decode(order[i], out_order + i * 3);
    return 0;
  }
  return 1;
}

}  // extern "C"
