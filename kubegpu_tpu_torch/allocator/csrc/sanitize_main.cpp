// Standalone sanitizer driver for the allocator core (SURVEY.md §6: build
// the C++ core with -fsanitize=address,undefined in CI tests; copied from
// kubegpu_tpu/allocator/csrc/sanitize_main.cpp, with switched nodes
// added).  Compiled as an executable so the ASan runtime loads first —
// dlopen-ing an instrumented .so into Python would need LD_PRELOAD
// gymnastics.
//
// Exercises every exported entry point across all registry mesh shapes,
// the switched H100 nodes' among them, with dense/sparse occupancy; exits
// nonzero on any semantic violation, and the sanitizers abort on any
// memory error.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
int32_t ktpu_find_free_placements(int32_t, int32_t, int32_t, int32_t,
                                  int32_t, int32_t, const uint8_t*, int32_t,
                                  int32_t, int32_t, int32_t, int32_t,
                                  int32_t*, int32_t*);
double ktpu_eval_order(int32_t, int32_t, int32_t, int32_t, int32_t, int32_t,
                       int32_t, int32_t, int32_t, int32_t, const int32_t*,
                       int32_t, const int32_t*, const double*, int32_t);
double ktpu_fragmentation_score(int32_t, int32_t, int32_t, int32_t, int32_t,
                                int32_t, const uint8_t*, const int32_t*,
                                int32_t);
int32_t ktpu_orient_rings(const int32_t*, const int32_t*, const int32_t*,
                          int32_t, int32_t, int32_t*);
int32_t ktpu_align_units(const int32_t*, const int32_t*, int32_t, int32_t,
                         int32_t*);
int32_t ktpu_connected_order(int32_t, int32_t, int32_t, int32_t, int32_t,
                             int32_t, int32_t, const uint8_t*, int32_t,
                             int32_t, int32_t, int32_t, int32_t, int32_t,
                             int32_t*);
}

struct MeshCase {
  int mx, my, mz, wx, wy, wz, sw, hx, hy, hz;
};

static uint32_t rng_state = 12345;
static uint32_t xorshift() {
  rng_state ^= rng_state << 13;
  rng_state ^= rng_state >> 17;
  rng_state ^= rng_state << 5;
  return rng_state;
}

int main() {
  const MeshCase meshes[] = {
      {2, 2, 1, 0, 0, 0, 0, 2, 2, 1},    {4, 4, 1, 0, 0, 0, 0, 2, 2, 1},
      {8, 8, 1, 0, 0, 0, 0, 2, 2, 1},    {16, 16, 1, 1, 1, 0, 0, 2, 2, 1},
      {4, 4, 4, 0, 0, 0, 0, 2, 2, 1},    {2, 2, 2, 0, 0, 0, 0, 2, 2, 1},
      // switched: one h100-sxm-8 node, and two 8-card hosts on one line
      {8, 1, 1, 0, 0, 0, 1, 8, 1, 1},    {16, 1, 1, 0, 0, 0, 1, 8, 1, 1},
  };
  const int shapes[][3] = {{1, 1, 1}, {2, 1, 1}, {4, 1, 1}, {2, 2, 1},
                           {4, 2, 1}, {4, 4, 1}, {2, 2, 2}, {8, 1, 1},
                           {16, 1, 1}};
  int checked = 0;
  for (const auto& m : meshes) {
    const int ncells = m.mx * m.my * m.mz;
    std::vector<uint8_t> occ(ncells);
    for (int density = 0; density <= 2; ++density) {
      for (int i = 0; i < ncells; ++i)
        occ[i] = density == 0 ? 0 : (xorshift() % 3 < (uint32_t)density);
      for (const auto& s : shapes) {
        if (s[0] > m.mx || s[1] > m.my || s[2] > m.mz) continue;
        const int vol = s[0] * s[1] * s[2];
        const int max_out = ncells;  // generous
        std::vector<int32_t> origins(max_out * 3);
        std::vector<int32_t> coords((size_t)max_out * vol * 3);
        int n = ktpu_find_free_placements(
            m.mx, m.my, m.mz, m.wx, m.wy, m.wz, occ.data(), s[0], s[1],
            s[2], 0, max_out, origins.data(), coords.data());
        if (n < 0) {
          std::fprintf(stderr, "overflow/width: n=%d\n", n);
          return 1;
        }
        for (int p = 0; p < n; ++p) {
          const int32_t* pc = coords.data() + (size_t)p * vol * 3;
          for (int j = 0; j < vol; ++j) {
            const int32_t* c = pc + j * 3;
            const int cell = (c[0] * m.my + c[1]) * m.mz + c[2];
            if (cell < 0 || cell >= ncells || occ[cell]) {
              std::fprintf(stderr, "bad placement cell\n");
              return 1;
            }
          }
          double frag = ktpu_fragmentation_score(
              m.mx, m.my, m.mz, m.wx, m.wy, m.wz, occ.data(), pc, vol);
          if (frag < 0.0 || frag > 1.0) {
            std::fprintf(stderr, "frag out of range: %f\n", frag);
            return 1;
          }
          if (vol >= 2 && vol % 2 == 0) {
            int32_t ax[2] = {2, vol / 2};
            double w[2] = {1.0, 4.0};
            double loc = ktpu_eval_order(m.mx, m.my, m.mz, m.wx, m.wy,
                                         m.wz, m.sw, m.hx, m.hy, m.hz, pc,
                                         vol, ax, w, 2);
            if (loc < 0.0 || loc > 1.0) {
              std::fprintf(stderr, "locality out of range: %f\n", loc);
              return 1;
            }
          }
          ++checked;
        }
      }
    }
  }
  // size-mismatch path must return -1, not crash
  int32_t order[6] = {0, 0, 0, 1, 0, 0};
  int32_t ax[1] = {4};
  double w[1] = {1.0};
  if (ktpu_eval_order(4, 4, 1, 0, 0, 0, 0, 2, 2, 1, order, 2, ax, w, 1) !=
      -1.0) {
    std::fprintf(stderr, "mismatch not detected\n");
    return 1;
  }
  // switched adjacency: cards 0 and 3 of one 8-card host are one hop
  // apart; cards 7 and 8 of two hosts are not, torus distance 1 or no
  int32_t far_pair[6] = {0, 0, 0, 3, 0, 0};
  int32_t cross_pair[6] = {7, 0, 0, 8, 0, 0};
  int32_t ax2[1] = {2};
  if (ktpu_eval_order(8, 1, 1, 0, 0, 0, 1, 8, 1, 1, far_pair, 2, ax2, w,
                      1) != 1.0 ||
      ktpu_eval_order(8, 1, 1, 0, 0, 0, 0, 8, 1, 1, far_pair, 2, ax2, w,
                      1) != 0.0 ||
      ktpu_eval_order(16, 1, 1, 0, 0, 0, 1, 8, 1, 1, cross_pair, 2, ax2, w,
                      1) != 0.0) {
    std::fprintf(stderr, "switched adjacency wrong\n");
    return 1;
  }

  // Viterbi entry points: random ring option sets, varied unit counts
  for (int n_units = 2; n_units <= 6; ++n_units) {
    const int opt_len = 4, n_var = 8;
    std::vector<int32_t> n_opts(n_units, n_var);
    std::vector<int32_t> opt_lens(n_units, opt_len);
    std::vector<int32_t> data((size_t)n_units * n_var * opt_len * 3);
    for (auto& v : data) v = (int32_t)(xorshift() % 8);
    std::vector<int32_t> choice(n_units, -1);
    if (ktpu_align_units(data.data(), n_opts.data(), opt_len, n_units,
                         choice.data()) != 0) {
      std::fprintf(stderr, "align_units failed\n");
      return 1;
    }
    for (int u = 0; u < n_units; ++u)
      if (choice[u] < 0 || choice[u] >= n_var) {
        std::fprintf(stderr, "align_units choice out of range\n");
        return 1;
      }
    for (int close = 0; close <= 1; ++close) {
      std::vector<int32_t> choice2(n_units, -1);
      if (ktpu_orient_rings(data.data(), n_opts.data(), opt_lens.data(),
                            n_units, close, choice2.data()) != 0) {
        std::fprintf(stderr, "orient_rings failed\n");
        return 1;
      }
      for (int u = 0; u < n_units; ++u)
        if (choice2[u] < 0 || choice2[u] >= n_var) {
          std::fprintf(stderr, "orient_rings choice out of range\n");
          return 1;
        }
    }
  }

  // connected-order fallback: output chips must be free and distinct
  for (const auto& m : meshes) {
    const int ncells = m.mx * m.my * m.mz;
    std::vector<uint8_t> occ(ncells);
    for (int i = 0; i < ncells; ++i) occ[i] = xorshift() % 3 == 0;
    for (int pods = 1; pods <= 4; ++pods) {
      for (int cpp = 1; cpp <= 2; ++cpp) {
        const int total = pods * cpp;
        if (total > ncells) continue;
        std::vector<int32_t> out((size_t)total * 3, -1);
        int rc = ktpu_connected_order(m.mx, m.my, m.mz, m.wx, m.wy, m.wz,
                                      m.sw, occ.data(), m.hx, m.hy, m.hz,
                                      total, cpp, pods, out.data());
        if (rc < 0) {
          std::fprintf(stderr, "connected_order bad args rc=%d\n", rc);
          return 1;
        }
        if (rc == 0) {
          std::vector<uint8_t> seen(ncells);
          for (int i = 0; i < total; ++i) {
            const int32_t* c = out.data() + i * 3;
            const int cell = (c[0] * m.my + c[1]) * m.mz + c[2];
            if (cell < 0 || cell >= ncells || occ[cell] || seen[cell]) {
              std::fprintf(stderr, "connected_order bad chip\n");
              return 1;
            }
            seen[cell] = 1;
          }
        }
        ++checked;
      }
    }
  }
  std::printf("sanitize OK: %d placements checked\n", checked);
  return 0;
}
