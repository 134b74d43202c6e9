// Runs both kernels on host threads (`par` blocks at a time) on seeded
// inputs, and holds dQ, dK and dV against the function in float64 (from
// the f32 lse and delta the kernels are given, widened) and reports a
// plain f32 loop's error beside the kernels'. Exit status: the number of
// outputs with a non-finite value or an error over 1e-4 of the largest.
#include <cstdio>
#include <random>
#include <cstdlib>
using namespace mxt;
using namespace mxt::wide;

template <bool DKV>
void launch(const Args& a, int B, int par) {
  const int nch = (a.d + kWCols - 1) / kWCols;
  gridDim = dim3(B * a.H * nch, ((DKV ? a.lk : a.lq) + kW - 1) / kW, 1);
  std::vector<std::pair<int, int>> blocks;
  for (unsigned y = 0; y < gridDim.y; ++y)
    for (unsigned x = 0; x < gridDim.x; ++x) blocks.push_back({(int)x, (int)y});
  for (size_t i0 = 0; i0 < blocks.size(); i0 += par) {
    std::vector<std::thread> ths;
    std::vector<std::unique_ptr<unsigned char[]>> smems;
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<std::unique_ptr<Warp[]>> warps;
    std::vector<std::unique_ptr<std::barrier<>>> wbars;
    for (size_t i = i0; i < std::min(blocks.size(), i0 + par); ++i) {
      smems.emplace_back(new unsigned char[X3<DKV>::SMEM + 256]);
      memset(smems.back().get(), 0xff, X3<DKV>::SMEM);  // NaN garbage
      bars.emplace_back(new std::barrier<>(kWThreads));
      warps.emplace_back(new Warp[kWThreads / 32]);
      for (int w = 0; w < kWThreads / 32; ++w) {
        wbars.emplace_back(new std::barrier<>(32));
        warps.back()[w].bar = wbars.back().get();
      }
      unsigned char* sm = smems.back().get();
      std::barrier<>* bb = bars.back().get();
      Warp* ww = warps.back().get();
      const auto blk = blocks[i];
      for (int t = 0; t < kWThreads; ++t)
        ths.emplace_back([=, &a]() {
          threadIdx = {(unsigned)t, 0, 0};
          blockIdx = {(unsigned)blk.first, (unsigned)blk.second, 0};
          g_smem = sm; g_block = bb; g_warps = ww;
          x3_wide_body<DKV>(a);
        });
    }
    for (auto& th : ths) th.join();
  }
}

struct T4 {  // a (B, H, L, D) tensor stored (B, H, L, D) or (B, L, H, D)
  int B, H, L, D; bool blhd; std::vector<float> v;
  T4(int b, int h, int l, int d, bool x) : B(b), H(h), L(l), D(d), blhd(x), v((size_t)b * h * l * d) {}
  Strides st() const {
    return blhd ? Strides{(long long)L * H * D, D, (long long)H * D}
                : Strides{(long long)H * L * D, (long long)L * D, D};
  }
  float& at(int b, int h, int l, int d) {
    Strides s = st(); return v[b * s.b + h * s.h + l * s.l + d];
  }
};

int main(int argc, char** argv) {
  // B H lq lk D causal kv_len seed par
  const int B = atoi(argv[1]), H = atoi(argv[2]), lq = atoi(argv[3]), lk = atoi(argv[4]);
  const int D = atoi(argv[5]), causal = atoi(argv[6]), kv_len = atoi(argv[7]);
  const int seed = atoi(argv[8]), par = argc > 9 ? atoi(argv[9]) : 1;
  std::mt19937 rng(seed);
  std::normal_distribution<float> nd;
  T4 q(B, H, lq, D, true), k(B, H, lk, D, true), v(B, H, lk, D, false), dO(B, H, lq, D, true);
  for (auto* t : {&q, &k, &v, &dO}) for (auto& x : t->v) x = nd(rng);
  const float scale = 1.f / std::sqrt((float)D);
  const int kv_lim = std::min(kv_len, lk), off = lk - lq;
  auto vis = [&](int i, int j) { return j < kv_lim && (!causal || j <= i + off); };
  std::vector<float> lse((size_t)B * H * lq), delta((size_t)B * H * lq);
  // float64 reference and the f32 plain version
  std::vector<double> rq(q.v.size()), rk(k.v.size()), rv(v.v.size());
  std::vector<double> pq(q.v.size()), pk(k.v.size()), pv(v.v.size());
  std::vector<double> S(lq * lk), P(lq * lk), dS(lq * lk);
  std::vector<float> Sf(lq * lk), Pf(lq * lk), dSf(lq * lk);
  for (int b = 0; b < B; ++b)
    for (int h = 0; h < H; ++h) {
      const size_t r0 = ((size_t)b * H + h) * lq;
      for (int i = 0; i < lq; ++i) {
        double m = -1e300;
        for (int j = 0; j < lk; ++j) {
          double s = 0;
          for (int d = 0; d < D; ++d) s += (double)q.at(b, h, i, d) * k.at(b, h, j, d);
          S[i * lk + j] = s;
          if (vis(i, j)) m = std::max(m, s * scale);
        }
        double l = 0;
        for (int j = 0; j < lk; ++j) if (vis(i, j)) l += std::exp(S[i * lk + j] * scale - m);
        lse[r0 + i] = l > 0 ? (float)(m + std::log(l)) : -INFINITY;
        double dl = 0;
        for (int d = 0; d < D; ++d) {
          double o = 0;
          for (int j = 0; j < lk; ++j)
            if (vis(i, j)) o += std::exp(S[i * lk + j] * scale - (m + std::log(l))) * v.at(b, h, j, d);
          dl += o * dO.at(b, h, i, d);
        }
        delta[r0 + i] = (float)dl;
      }
      // the function, in float64 on the f32 lse and delta, and in f32
      for (int i = 0; i < lq; ++i)
        for (int j = 0; j < lk; ++j) {
          double dp = 0; float sf = 0, dpf = 0;
          for (int d = 0; d < D; ++d) {
            dp += (double)dO.at(b, h, i, d) * v.at(b, h, j, d);
            sf += q.at(b, h, i, d) * k.at(b, h, j, d);
            dpf += dO.at(b, h, i, d) * v.at(b, h, j, d);
          }
          const double p = vis(i, j) ? std::exp(S[i * lk + j] * scale - (double)lse[r0 + i]) : 0;
          P[i * lk + j] = p; dS[i * lk + j] = p * (dp - delta[r0 + i]) * scale;
          const float pf = vis(i, j) ? expf(sf * scale - lse[r0 + i]) : 0.f;
          Pf[i * lk + j] = pf; dSf[i * lk + j] = pf * (dpf - delta[r0 + i]) * scale;
        }
      for (int d = 0; d < D; ++d) {
        for (int i = 0; i < lq; ++i) {
          double s = 0; float sf = 0;
          for (int j = 0; j < lk; ++j) { s += dS[i * lk + j] * k.at(b, h, j, d); sf += dSf[i * lk + j] * k.at(b, h, j, d); }
          rq[q.st().b * b + q.st().h * h + q.st().l * i + d] = s;
          pq[q.st().b * b + q.st().h * h + q.st().l * i + d] = sf;
        }
        for (int j = 0; j < lk; ++j) {
          double sk = 0, sv = 0; float fk = 0, fv = 0;
          for (int i = 0; i < lq; ++i) {
            sk += dS[i * lk + j] * q.at(b, h, i, d); sv += P[i * lk + j] * dO.at(b, h, i, d);
            fk += dSf[i * lk + j] * q.at(b, h, i, d); fv += Pf[i * lk + j] * dO.at(b, h, i, d);
          }
          rk[k.st().b * b + k.st().h * h + k.st().l * j + d] = sk;
          pk[k.st().b * b + k.st().h * h + k.st().l * j + d] = fk;
          rv[v.st().b * b + v.st().h * h + v.st().l * j + d] = sv;
          pv[v.st().b * b + v.st().h * h + v.st().l * j + d] = fv;
        }
      }
    }
  // outputs: dQ like q, dK like k, dV like v, filled with NaN
  T4 gq = q, gk = k, gv = v;
  for (auto* t : {&gq, &gk, &gv}) std::fill(t->v.begin(), t->v.end(), NAN);
  Args a{};
  a.q = q.v.data(); a.k = k.v.data(); a.v = v.v.data(); a.dout = dO.v.data();
  a.lse = lse.data(); a.delta = delta.data();
  a.dq = gq.v.data(); a.dk = gk.v.data(); a.dv = gv.v.data();
  a.H = H; a.lq = lq; a.lk = lk; a.d = D;
  a.sq = q.st(); a.sk = k.st(); a.sv = v.st(); a.sdo = dO.st();
  a.sdq = gq.st(); a.sdk = gk.st(); a.sdv = gv.st();
  a.scale = scale; a.causal = causal; a.kv_len = kv_len;
  launch<false>(a, B, par);
  launch<true>(a, B, par);
  int bad = 0;
  auto report = [&](const char* name, const std::vector<float>& got, const std::vector<double>& want, const std::vector<double>& plain) {
    double e = 0, ep = 0, mx = 0; size_t nan = 0;
    for (size_t i = 0; i < got.size(); ++i) {
      if (!std::isfinite(got[i])) { ++nan; continue; }
      e = std::max(e, std::fabs(got[i] - want[i]));
      ep = std::max(ep, std::fabs(plain[i] - want[i]));
      mx = std::max(mx, std::fabs(want[i]));
    }
    const bool ok = nan == 0 && e <= 1e-4 * std::max(1.0, mx);
    printf("%s: max|ref| %.3e kernel err %.3e plain f32 err %.3e ratio %.2f nonfinite %zu %s\n",
           name, mx, e, ep, ep > 0 ? e / ep : 0.0, nan, ok ? "ok" : "BAD");
    bad += !ok;
  };
  report("dq", gq.v, rq, pq);
  report("dk", gk.v, rk, pk);
  report("dv", gv.v, rv, pv);
  return bad;
}
