// Head-to-head baseline: times the UNMODIFIED reference kernels
// (/root/reference/src/Kernels/{default,AVX-SSE}) on this host CPU, the
// same way the reference's own harness does (time_kernel,
// /root/reference/src/impl/main.cpp:240-295: re-inject num_threads, fresh
// kernel, repeated compute/score calls, mean wall time) — but reporting
// GCUPS so the numbers compare directly against the device paths'.
//
// Like tests/golden/gen_golden.cpp, this LINKS the reference sources
// through their public plugin interface; no reference code is copied or
// shipped in the package. Build/run: scripts/reference_bench/run.sh
// (writes REFERENCE_BENCH.json at the repo root).

#include "AlignmentKernel.h"
#include "AlignmentLogger.h"
#include "AlignmentParameters.h"
#include "AVXKernel.h"
#include "DefaultKernel.h"
#include "SSEKernel.h"

#include <chrono>
#include <cstdarg>
#include <cstdio>
#include <map>
#include <string>
#include <vector>

AlignmentParameters *_parameters = 0;
AlignmentLogger *_logger = 0;

struct Params : AlignmentParameters {
  std::map<std::string, int> kv;
  int param_int(char const *const key) override { return kv.at(key); }
  bool has_key(char const *const key) override { return kv.count(key) > 0; }
};

struct NullLogger : AlignmentLogger {
  void log(int const, char const *const, char const *const, size_t const &,
           ...) override {}
};

static unsigned long long lcg_state = 0x9E3779B97F4A7C15ull;
static unsigned lcg() {
  lcg_state = lcg_state * 6364136223846793005ull + 1442695040888963407ull;
  return (unsigned)(lcg_state >> 33);
}

static double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

template <typename K>
static double bench_one(int n, int len, const char *const *reads,
                        const char *const *refs, bool align, int loops) {
  // Fresh kernel per run: the ctor snapshots Parameters (num_threads etc.),
  // exactly as the reference harness re-spawns kernels per thread setting.
  double best = 1e30;
  for (int l = 0; l < loops; ++l) {
    K kernel;
    double t0 = now_s();
    if (align) {
      std::vector<Alignment> out(n);
      kernel.compute_alignments(0, n, reads, refs, out.data());
      // Alignment's destructor frees the kernel-allocated strings.
    } else {
      std::vector<short> scores(n, 0);
      kernel.score_alignments(0, n, reads, refs, scores.data());
    }
    double dt = now_s() - t0;
    if (dt < best) best = dt;
  }
  return (double)n * len * len / best / 1e9;  // GCUPS
}

int main(int argc, char **argv) {
  const char *out_path = argc > 1 ? argv[1] : "REFERENCE_BENCH.json";
  const int len = 512;
  const int n_score = 512, n_align = 128, loops = 3;

  NullLogger logger;
  _logger = &logger;

  std::vector<std::string> seqs;
  std::vector<const char *> reads, refs;
  static const char bases[] = "ACGT";
  for (int i = 0; i < 2 * n_score; ++i) {
    std::string s(len, 'A');
    for (int j = 0; j < len; ++j) s[j] = bases[lcg() % 4];
    seqs.push_back(s);
  }
  for (int i = 0; i < n_score; ++i) {
    reads.push_back(seqs[2 * i].c_str());
    refs.push_back(seqs[2 * i + 1].c_str());
  }

  FILE *f = fopen(out_path, "w");
  if (!f) return 1;
  fprintf(f, "{\n  \"config\": \"512x512 SW, %d pairs score / %d align, "
             "min-of-%d GCUPS\",\n",
          n_score, n_align, loops);

  int thread_counts[] = {1, 2, 4};
  const char *names[] = {"default", "sse", "avx"};
  for (int k = 0; k < 3; ++k) {
    fprintf(f, "  \"%s\": {", names[k]);
    for (int m = 0; m < 2; ++m) {
      bool align = m == 1;
      int n = align ? n_align : n_score;
      fprintf(f, "%s\"%s\": {", m ? ", " : "", align ? "align" : "score");
      for (int ti = 0; ti < 3; ++ti) {
        Params params;
        params.kv = {{"score_match", 2},     {"score_mismatch", -1},
                     {"score_gap_read", -3}, {"score_gap_ref", -3},
                     {"read_length", len},   {"ref_length", len},
                     {"num_threads", thread_counts[ti]}};
        _parameters = &params;
        double gcups = 0;
        if (k == 0)
          gcups = bench_one<DefaultKernel>(n, len, reads.data(), refs.data(),
                                           align, loops);
        else if (k == 1)
          gcups = bench_one<SSEKernel>(n, len, reads.data(), refs.data(),
                                       align, loops);
        else
          gcups = bench_one<AVXKernel>(n, len, reads.data(), refs.data(),
                                       align, loops);
        fprintf(f, "%s\"t%d\": %.3f", ti ? ", " : "", thread_counts[ti],
                gcups);
        fprintf(stderr, "%s %s t=%d: %.3f GCUPS\n", names[k],
                align ? "align" : "score", thread_counts[ti], gcups);
      }
      fprintf(f, "}");
    }
    fprintf(f, "}%s\n", k < 2 ? "," : "");
  }
  fprintf(f, "}\n");
  fclose(f);
  return 0;
}
