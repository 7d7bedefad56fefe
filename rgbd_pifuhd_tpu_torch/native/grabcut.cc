// GrabCut foreground segmentation seeded by a rectangle (Rother,
// Kolmogorov and Blake 2004), step for step as OpenCV's cv::grabCut with
// GC_INIT_WITH_RECT computes it (imgproc/src/grabcut.cpp, gcgraph.hpp):
//
//   - the mask starts as background outside the rectangle and "probably
//     foreground" inside it;
//   - two 5-component full-covariance colour GMMs, initialised by k-means
//     (k-means++ seeding with 3 trials a centre, 10 iterations) on the
//     pixels outside / inside;
//   - 8-neighbour n-links gamma * exp(-beta |dc|^2) (diagonals divided by
//     sqrt 2), beta = 1 / (2 <|dc|^2>) over all neighbour pairs, gamma 50;
//     t-links -log p(colour | GMM) for undecided pixels, lambda = 9 gamma
//     for fixed ones;
//   - `iters` rounds of reassigning each pixel's GMM component, relearning
//     the GMMs and a min cut by the Boykov-Kolmogorov max-flow (OpenCV's
//     GCGraph: the same search-tree growth, augmentation and orphan
//     adoption order).
//
// k-means draws from OpenCV's multiply-with-carry generator in the state a
// fresh thread's cv::theRNG() starts in, so a process's first
// cv2.grabCut call is the one this reproduces draw for draw.
//
// grabcut_rect returns 0, or 1 where OpenCV raises cv::Exception (an
// empty rectangle or outside, no pixel outside it, a singular GMM).

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

enum { GC_BGD = 0, GC_FGD = 1, GC_PR_BGD = 2, GC_PR_FGD = 3 };

struct Failure {};

inline void check(bool ok) {
  if (!ok) throw Failure();
}

// cv::RNG: state = low32(state) * 4164903690 + high32(state)
struct Rng {
  uint64_t state = 0xffffffffULL;
  unsigned next() {
    state = (uint64_t)(unsigned)state * 4164903690U + (unsigned)(state >> 32);
    return (unsigned)state;
  }
  double uniform() {  // RNG::operator double
    unsigned t = next();
    return (((uint64_t)t << 32) | next()) *
           5.4210108624275221700372640043497e-20;
  }
};

inline float norm_l2_sqr(const float* a, const float* b) {
  float d = 0.f;
  for (int j = 0; j < 3; j++) {
    float t = a[j] - b[j];
    d += t * t;
  }
  return d;
}

// cv::kmeans(data, K, labels, TermCriteria(COUNT, 10, 0), 1,
//            KMEANS_PP_CENTERS) on [N, 3] float samples.
void kmeans(const std::vector<float>& data, int N, int K, Rng& rng,
            std::vector<int>& labels) {
  const int trials = 3;
  const int max_count = 10;
  const double eps = (double)std::numeric_limits<float>::epsilon() *
                     std::numeric_limits<float>::epsilon();
  labels.assign(N, 0);
  std::vector<float> centers(K * 3), old_centers(K * 3);
  std::vector<int> counters(K);
  const float* x = data.data();

  for (int iter = 0;;) {
    double max_center_shift = iter == 0 ? std::numeric_limits<double>::max()
                                        : 0.0;
    std::swap(centers, old_centers);
    if (iter == 0) {
      // generateCentersPP
      std::vector<int> cidx(K);
      std::vector<float> dist(N), tdist(N), tdist2(N);
      double sum0 = 0;
      cidx[0] = (int)(rng.next() % (unsigned)N);
      for (int i = 0; i < N; i++) {
        dist[i] = norm_l2_sqr(x + 3 * i, x + 3 * cidx[0]);
        sum0 += dist[i];
      }
      for (int k = 1; k < K; k++) {
        double best_sum = std::numeric_limits<double>::max();
        int best_center = -1;
        for (int j = 0; j < trials; j++) {
          double p = rng.uniform() * sum0;
          int ci = 0;
          for (; ci < N - 1; ci++) {
            p -= dist[ci];
            if (p <= 0) break;
          }
          for (int i = 0; i < N; i++)
            tdist2[i] = std::min(norm_l2_sqr(x + 3 * i, x + 3 * ci), dist[i]);
          double s = 0;
          for (int i = 0; i < N; i++) s += tdist2[i];
          if (s < best_sum) {
            best_sum = s;
            best_center = ci;
            std::swap(tdist, tdist2);
          }
        }
        check(best_center >= 0);
        cidx[k] = best_center;
        sum0 = best_sum;
        std::swap(dist, tdist);
      }
      for (int k = 0; k < K; k++)
        for (int j = 0; j < 3; j++) centers[k * 3 + j] = x[cidx[k] * 3 + j];
    } else {
      std::fill(centers.begin(), centers.end(), 0.f);
      std::fill(counters.begin(), counters.end(), 0);
      for (int i = 0; i < N; i++) {
        float* c = &centers[labels[i] * 3];
        for (int j = 0; j < 3; j++) c[j] += x[i * 3 + j];
        counters[labels[i]]++;
      }
      for (int k = 0; k < K; k++) {
        if (counters[k] != 0) continue;
        // an empty cluster takes the farthest point of the biggest one
        int max_k = 0;
        for (int k1 = 1; k1 < K; k1++)
          if (counters[max_k] < counters[k1]) max_k = k1;
        double max_dist = 0;
        int farthest_i = -1;
        float* base_center = &centers[max_k * 3];
        float scaled[3];
        float scale = 1.f / counters[max_k];
        for (int j = 0; j < 3; j++) scaled[j] = base_center[j] * scale;
        for (int i = 0; i < N; i++) {
          if (labels[i] != max_k) continue;
          double d = norm_l2_sqr(x + 3 * i, scaled);
          if (max_dist <= d) {
            max_dist = d;
            farthest_i = i;
          }
        }
        check(farthest_i >= 0);
        counters[max_k]--;
        counters[k]++;
        labels[farthest_i] = k;
        float* cur = &centers[k * 3];
        for (int j = 0; j < 3; j++) {
          base_center[j] -= x[farthest_i * 3 + j];
          cur[j] += x[farthest_i * 3 + j];
        }
      }
      for (int k = 0; k < K; k++) {
        float* c = &centers[k * 3];
        check(counters[k] != 0);
        float scale = 1.f / counters[k];
        for (int j = 0; j < 3; j++) c[j] *= scale;
        if (iter > 0) {
          double d = 0;
          for (int j = 0; j < 3; j++) {
            double t = c[j] - old_centers[k * 3 + j];
            d += t * t;
          }
          max_center_shift = std::max(max_center_shift, d);
        }
      }
    }
    bool last = (++iter == std::max(max_count, 2) || max_center_shift <= eps);
    if (last) break;  // labels are not reassigned after the last centres
    for (int i = 0; i < N; i++) {
      int k_best = 0;
      double min_dist = std::numeric_limits<double>::max();
      for (int k = 0; k < K; k++) {
        double d = norm_l2_sqr(x + 3 * i, &centers[k * 3]);
        if (min_dist > d) {
          min_dist = d;
          k_best = k;
        }
      }
      labels[i] = k_best;
    }
  }
}

struct GMM {
  static const int K = 5;
  double coefs[K] = {0}, mean[K * 3] = {0}, cov[K * 9] = {0};
  double inv_cov[K][3][3], cov_det[K];
  double sums[K][3], prods[K][3][3];
  int counts[K], total = 0;

  double component(int ci, const double* c) const {
    if (!(coefs[ci] > 0)) return 0;
    check(cov_det[ci] > std::numeric_limits<double>::epsilon());
    const double* m = mean + 3 * ci;
    double d0 = c[0] - m[0], d1 = c[1] - m[1], d2 = c[2] - m[2];
    const double(*ic)[3] = inv_cov[ci];
    double mult =
        d0 * (d0 * ic[0][0] + d1 * ic[1][0] + d2 * ic[2][0]) +
        d1 * (d0 * ic[0][1] + d1 * ic[1][1] + d2 * ic[2][1]) +
        d2 * (d0 * ic[0][2] + d1 * ic[1][2] + d2 * ic[2][2]);
    return 1.0f / std::sqrt(cov_det[ci]) * std::exp(-0.5f * mult);
  }
  double operator()(const double* c) const {
    double res = 0;
    for (int ci = 0; ci < K; ci++) res += coefs[ci] * component(ci, c);
    return res;
  }
  int which(const double* c) const {
    int k = 0;
    double best = 0;
    for (int ci = 0; ci < K; ci++) {
      double p = component(ci, c);
      if (p > best) {
        k = ci;
        best = p;
      }
    }
    return k;
  }
  void init_learning() {
    std::memset(sums, 0, sizeof(sums));
    std::memset(prods, 0, sizeof(prods));
    std::memset(counts, 0, sizeof(counts));
    total = 0;
  }
  void add(int ci, const double* c) {
    for (int a = 0; a < 3; a++) {
      sums[ci][a] += c[a];
      for (int b = 0; b < 3; b++) prods[ci][a][b] += c[a] * c[b];
    }
    counts[ci]++;
    total++;
  }
  void calc_inverse(int ci, double singular_fix) {
    if (!(coefs[ci] > 0)) return;
    double* c = cov + 9 * ci;
    double dtrm = c[0] * (c[4] * c[8] - c[5] * c[7]) -
                  c[1] * (c[3] * c[8] - c[5] * c[6]) +
                  c[2] * (c[3] * c[7] - c[4] * c[6]);
    if (dtrm <= 1e-6 && singular_fix > 0) {
      c[0] += singular_fix;
      c[4] += singular_fix;
      c[8] += singular_fix;
      dtrm = c[0] * (c[4] * c[8] - c[5] * c[7]) -
             c[1] * (c[3] * c[8] - c[5] * c[6]) +
             c[2] * (c[3] * c[7] - c[4] * c[6]);
    }
    cov_det[ci] = dtrm;
    check(dtrm > std::numeric_limits<double>::epsilon());
    double inv = 1.0 / dtrm;
    inv_cov[ci][0][0] = (c[4] * c[8] - c[5] * c[7]) * inv;
    inv_cov[ci][1][0] = -(c[3] * c[8] - c[5] * c[6]) * inv;
    inv_cov[ci][2][0] = (c[3] * c[7] - c[4] * c[6]) * inv;
    inv_cov[ci][0][1] = -(c[1] * c[8] - c[2] * c[7]) * inv;
    inv_cov[ci][1][1] = (c[0] * c[8] - c[2] * c[6]) * inv;
    inv_cov[ci][2][1] = -(c[0] * c[7] - c[1] * c[6]) * inv;
    inv_cov[ci][0][2] = (c[1] * c[5] - c[2] * c[4]) * inv;
    inv_cov[ci][1][2] = -(c[0] * c[5] - c[2] * c[3]) * inv;
    inv_cov[ci][2][2] = (c[0] * c[4] - c[1] * c[3]) * inv;
  }
  void end_learning() {
    for (int ci = 0; ci < K; ci++) {
      int n = counts[ci];
      if (n == 0) {
        coefs[ci] = 0;
        continue;
      }
      check(total > 0);
      double inv_n = 1.0 / n;
      coefs[ci] = (double)n / total;
      double* m = mean + 3 * ci;
      for (int a = 0; a < 3; a++) m[a] = sums[ci][a] * inv_n;
      double* c = cov + 9 * ci;
      for (int a = 0; a < 3; a++)
        for (int b = 0; b < 3; b++)
          c[a * 3 + b] = prods[ci][a][b] * inv_n - m[a] * m[b];
      calc_inverse(ci, 0.01);
    }
  }
};

// OpenCV's GCGraph<double>: Boykov-Kolmogorov max-flow.
class Graph {
 public:
  struct Vtx {
    Vtx* next;
    int parent;
    int first;
    int ts;
    int dist;
    double weight;
    unsigned char t;
  };
  struct Edge {
    int dst;
    int next;
    double weight;
  };

  Graph(int n_vtx, int n_edges) {
    vtcs.reserve(n_vtx);
    edges.reserve(n_edges + 2);
  }
  int add_vtx() {
    Vtx v;
    std::memset(&v, 0, sizeof(Vtx));
    vtcs.push_back(v);
    return (int)vtcs.size() - 1;
  }
  void add_edges(int i, int j, double w, double revw) {
    check(w >= 0 && revw >= 0 && i != j);
    if (edges.empty()) edges.resize(2);
    Edge from_i{j, vtcs[i].first, w};
    vtcs[i].first = (int)edges.size();
    edges.push_back(from_i);
    Edge to_i{i, vtcs[j].first, revw};
    vtcs[j].first = (int)edges.size();
    edges.push_back(to_i);
  }
  void add_term_weights(int i, double source_w, double sink_w) {
    double dw = vtcs[i].weight;
    if (dw > 0)
      source_w += dw;
    else
      sink_w -= dw;
    flow += (source_w < sink_w) ? source_w : sink_w;
    vtcs[i].weight = source_w - sink_w;
  }
  bool in_source_segment(int i) const { return vtcs[i].t == 0; }

  double max_flow() {
    check(!vtcs.empty() && !edges.empty());
    const int TERMINAL = -1, ORPHAN = -2;
    Vtx stub, *nil = &stub, *first = nil, *last = nil;
    int curr_ts = 0;
    stub.next = nil;
    Vtx* vp = &vtcs[0];
    Edge* ep = &edges[0];
    std::vector<Vtx*> orphans;

    for (size_t i = 0; i < vtcs.size(); i++) {
      Vtx* v = vp + i;
      v->ts = 0;
      if (v->weight != 0) {
        last = last->next = v;
        v->dist = 1;
        v->parent = TERMINAL;
        v->t = v->weight < 0;
      } else {
        v->parent = 0;
      }
    }
    first = first->next;
    last->next = nil;
    nil->next = 0;

    for (;;) {
      Vtx *v, *u;
      int e0 = -1, ei = 0, ej = 0;
      double min_weight, weight;
      unsigned char vt;

      // grow the S and T search trees; find an edge that joins them
      while (first != nil) {
        v = first;
        if (v->parent) {
          vt = v->t;
          for (ei = v->first; ei != 0; ei = ep[ei].next) {
            if (ep[ei ^ vt].weight == 0) continue;
            u = vp + ep[ei].dst;
            if (!u->parent) {
              u->t = vt;
              u->parent = ei ^ 1;
              u->ts = v->ts;
              u->dist = v->dist + 1;
              if (!u->next) {
                u->next = nil;
                last = last->next = u;
              }
              continue;
            }
            if (u->t != vt) {
              e0 = ei ^ vt;
              break;
            }
            if (u->dist > v->dist + 1 && u->ts <= v->ts) {
              u->parent = ei ^ 1;
              u->ts = v->ts;
              u->dist = v->dist + 1;
            }
          }
          if (e0 > 0) break;
        }
        first = first->next;
        v->next = 0;
      }
      if (e0 <= 0) break;

      // the bottleneck of the path
      min_weight = ep[e0].weight;
      check(min_weight > 0);
      for (int k = 1; k >= 0; k--) {
        for (v = vp + ep[e0 ^ k].dst;; v = vp + ep[ei].dst) {
          if ((ei = v->parent) < 0) break;
          weight = ep[ei ^ k].weight;
          min_weight = std::min(min_weight, weight);
          check(min_weight > 0);
        }
        weight = std::fabs(v->weight);
        min_weight = std::min(min_weight, weight);
        check(min_weight > 0);
      }

      // augment; saturated tree edges make orphans
      ep[e0].weight -= min_weight;
      ep[e0 ^ 1].weight += min_weight;
      flow += min_weight;
      for (int k = 1; k >= 0; k--) {
        for (v = vp + ep[e0 ^ k].dst;; v = vp + ep[ei].dst) {
          if ((ei = v->parent) < 0) break;
          ep[ei ^ (k ^ 1)].weight += min_weight;
          if ((ep[ei ^ k].weight -= min_weight) == 0) {
            orphans.push_back(v);
            v->parent = ORPHAN;
          }
        }
        v->weight = v->weight + min_weight * (1 - k * 2);
        if (v->weight == 0) {
          orphans.push_back(v);
          v->parent = ORPHAN;
        }
      }

      // adopt the orphans
      curr_ts++;
      while (!orphans.empty()) {
        Vtx* v2 = orphans.back();
        orphans.pop_back();
        int d, min_dist = INT_MAX;
        e0 = 0;
        vt = v2->t;
        for (ei = v2->first; ei != 0; ei = ep[ei].next) {
          if (ep[ei ^ (vt ^ 1)].weight == 0) continue;
          u = vp + ep[ei].dst;
          if (u->t != vt || u->parent == 0) continue;
          for (d = 0;;) {
            if (u->ts == curr_ts) {
              d += u->dist;
              break;
            }
            ej = u->parent;
            d++;
            if (ej < 0) {
              if (ej == ORPHAN) {
                d = INT_MAX - 1;
              } else {
                u->ts = curr_ts;
                u->dist = 1;
              }
              break;
            }
            u = vp + ep[ej].dst;
          }
          if (++d < INT_MAX) {
            if (d < min_dist) {
              min_dist = d;
              e0 = ei;
            }
            for (u = vp + ep[ei].dst; u->ts != curr_ts;
                 u = vp + ep[u->parent].dst) {
              u->ts = curr_ts;
              u->dist = --d;
            }
          }
        }
        if ((v2->parent = e0) > 0) {
          v2->ts = curr_ts;
          v2->dist = min_dist;
          continue;
        }
        v2->ts = 0;
        for (ei = v2->first; ei != 0; ei = ep[ei].next) {
          u = vp + ep[ei].dst;
          ej = u->parent;
          if (u->t != vt || !ej) continue;
          if (ep[ei ^ (vt ^ 1)].weight && !u->next) {
            u->next = nil;
            last = last->next = u;
          }
          if (ej > 0 && vp + ep[ej].dst == v2) {
            orphans.push_back(u);
            u->parent = ORPHAN;
          }
        }
      }
    }
    return flow;
  }

 private:
  std::vector<Vtx> vtcs;
  std::vector<Edge> edges;
  double flow = 0;
};

inline double sq_diff(const uint8_t* a, const uint8_t* b) {
  double s = 0;
  for (int c = 0; c < 3; c++) {
    double d = (double)a[c] - (double)b[c];
    s += d * d;
  }
  return s;
}

inline bool is_bgd(uint8_t m) { return m == GC_BGD || m == GC_PR_BGD; }

void grabcut(const uint8_t* img, int H, int W, int rx, int ry, int rw, int rh,
             int iters, uint8_t* mask) {
  // initMaskWithRect
  std::memset(mask, GC_BGD, (size_t)H * W);
  rx = std::max(0, rx);
  ry = std::max(0, ry);
  rw = std::min(rw, W - rx);
  rh = std::min(rh, H - ry);
  check(rw >= 0 && rh >= 0);
  for (int y = ry; y < ry + rh; y++)
    std::memset(mask + (size_t)y * W + rx, GC_PR_FGD, rw);

  // initGMMs
  GMM bgd, fgd;
  std::vector<float> bs, fs;
  for (int i = 0; i < H * W; i++) {
    std::vector<float>& dst = is_bgd(mask[i]) ? bs : fs;
    for (int c = 0; c < 3; c++) dst.push_back(img[i * 3 + c]);
  }
  check(!bs.empty() && !fs.empty());
  Rng rng;
  std::vector<int> bl, fl;
  int nb = (int)bs.size() / 3, nf = (int)fs.size() / 3;
  kmeans(bs, nb, std::min(GMM::K, nb), rng, bl);
  kmeans(fs, nf, std::min(GMM::K, nf), rng, fl);
  double col[3];
  bgd.init_learning();
  for (int i = 0; i < nb; i++) {
    for (int c = 0; c < 3; c++) col[c] = bs[i * 3 + c];
    bgd.add(bl[i], col);
  }
  bgd.end_learning();
  fgd.init_learning();
  for (int i = 0; i < nf; i++) {
    for (int c = 0; c < 3; c++) col[c] = fs[i * 3 + c];
    fgd.add(fl[i], col);
  }
  fgd.end_learning();
  if (iters <= 0) return;

  const double gamma = 50, lambda = 9 * gamma;
  // calcBeta
  double beta = 0;
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++) {
      const uint8_t* p = img + ((size_t)y * W + x) * 3;
      if (x > 0) beta += sq_diff(p, p - 3);
      if (y > 0 && x > 0) beta += sq_diff(p, p - (size_t)(W + 1) * 3);
      if (y > 0) beta += sq_diff(p, p - (size_t)W * 3);
      if (y > 0 && x < W - 1) beta += sq_diff(p, p - (size_t)(W - 1) * 3);
    }
  if (beta <= std::numeric_limits<double>::epsilon())
    beta = 0;
  else
    beta = 1.f / (2 * beta / (4 * W * H - 3 * W - 3 * H + 2));

  // calcNWeights: left, up-left, up, up-right
  const double gamma_diag = gamma / std::sqrt(2.0f);
  std::vector<double> nw((size_t)H * W * 4, 0.0);
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++) {
      size_t i = (size_t)y * W + x;
      const uint8_t* p = img + i * 3;
      double* w = &nw[i * 4];
      if (x > 0) w[0] = gamma * std::exp(-beta * sq_diff(p, p - 3));
      if (x > 0 && y > 0)
        w[1] = gamma_diag *
               std::exp(-beta * sq_diff(p, p - (size_t)(W + 1) * 3));
      if (y > 0) w[2] = gamma * std::exp(-beta * sq_diff(p, p - (size_t)W * 3));
      if (x < W - 1 && y > 0)
        w[3] = gamma_diag *
               std::exp(-beta * sq_diff(p, p - (size_t)(W - 1) * 3));
    }

  std::vector<int> comp((size_t)H * W);
  const int n_edges = 2 * (4 * W * H - 3 * (W + H) + 2);
  for (int it = 0; it < iters; it++) {
    // assignGMMsComponents
    for (int i = 0; i < H * W; i++) {
      for (int c = 0; c < 3; c++) col[c] = img[i * 3 + c];
      comp[i] = is_bgd(mask[i]) ? bgd.which(col) : fgd.which(col);
    }
    // learnGMMs
    bgd.init_learning();
    fgd.init_learning();
    for (int ci = 0; ci < GMM::K; ci++)
      for (int i = 0; i < H * W; i++) {
        if (comp[i] != ci) continue;
        for (int c = 0; c < 3; c++) col[c] = img[i * 3 + c];
        if (is_bgd(mask[i]))
          bgd.add(ci, col);
        else
          fgd.add(ci, col);
      }
    bgd.end_learning();
    fgd.end_learning();
    // constructGCGraph
    Graph graph(H * W, n_edges);
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++) {
        int v = graph.add_vtx();
        for (int c = 0; c < 3; c++) col[c] = img[(size_t)v * 3 + c];
        double from_source, to_sink;
        uint8_t m = mask[v];
        if (m == GC_PR_BGD || m == GC_PR_FGD) {
          from_source = -std::log(bgd(col));
          to_sink = -std::log(fgd(col));
        } else if (m == GC_BGD) {
          from_source = 0;
          to_sink = lambda;
        } else {
          from_source = lambda;
          to_sink = 0;
        }
        graph.add_term_weights(v, from_source, to_sink);
        const double* w = &nw[(size_t)v * 4];
        if (x > 0) graph.add_edges(v, v - 1, w[0], w[0]);
        if (x > 0 && y > 0) graph.add_edges(v, v - W - 1, w[1], w[1]);
        if (y > 0) graph.add_edges(v, v - W, w[2], w[2]);
        if (x < W - 1 && y > 0) graph.add_edges(v, v - W + 1, w[3], w[3]);
      }
    // estimateSegmentation
    graph.max_flow();
    for (int i = 0; i < H * W; i++)
      if (mask[i] == GC_PR_BGD || mask[i] == GC_PR_FGD)
        mask[i] = graph.in_source_segment(i) ? GC_PR_FGD : GC_PR_BGD;
  }
}

}  // namespace

extern "C" {

// img: [H, W, 3] uint8 (any channel order); rect (x, y, w, h); mask out
// [H, W] uint8 with OpenCV's GC_* values.  Returns 0, or 1 where OpenCV
// raises.
int grabcut_rect(const uint8_t* img, int64_t H, int64_t W, int rx, int ry,
                 int rw, int rh, int iters, uint8_t* mask) {
  try {
    grabcut(img, (int)H, (int)W, rx, ry, rw, rh, iters, mask);
  } catch (const Failure&) {
    return 1;
  }
  return 0;
}

}  // extern "C"
