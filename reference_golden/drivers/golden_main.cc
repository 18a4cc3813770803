/* Golden-output generator: drives the UNMODIFIED reference BTK 2.0 C++ code
 * (/root/reference/btk20_src, compiled against the GSL shim in ../shim)
 * over raw sample files and dumps the results, so the JAX framework's
 * outputs can be asserted allclose against the true reference — not against
 * transliterations that share authorship with the implementation under test.
 *
 * File formats (all little-endian, no headers):
 *   .f32  float32 samples          .f64  float64 (prototypes, delays)
 *   .c128 complex128 interleaved   (analysis frames, [T, M] row-major)
 *
 * Subcommands:
 *   analysis h.f64 M m r dc in.f32 out.c128
 *   recon    h.f64 g.f64 M m r dc in.f32 out.f32
 *   ds       h.f64 g.f64 M m r dc fs delays.f64 out.f32 in1.f32 [in2.f32 ...]
 *   zelinski h.f64 g.f64 M m r dc fs delays.f64 alpha pftype minframes \
 *            out.f32 in1.f32 [...]          (GSC quiescent + Zelinski PF)
 *   gscrls   h.f64 g.f64 M m r dc fs delays.f64 mu sigma2 alpha qctype \
 *            out.f32 in1.f32 [...]          (C++ SubbandGSCRLS adaptation)
 */

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "common/jpython_error.h"
#include "stream/stream.h"
#include "modulated/modulated.h"
#include "beamformer/beamformer.h"
#include "postfilter/postfilter.h"
#include "dereverberation/dereverberation.h"
#include "beamformer/modalbeamformer.h"
#include "beamformer/tracker.h"
#include "aec/aec.h"
#include "square_root/square_root.h"

/* The python error bridge (common/jpython_error.cc) needs libpython; the
 * golden drivers never raise through python, so provide the one symbol. */
jpython_error::jpython_error() : j_error() {}

/* ------------------------------------------------------------------ */

static std::vector<float> read_f32(const char* fn) {
  FILE* fp = fopen(fn, "rb");
  if (!fp) { fprintf(stderr, "cannot open %s\n", fn); exit(1); }
  fseek(fp, 0, SEEK_END);
  long n = ftell(fp) / (long)sizeof(float);
  fseek(fp, 0, SEEK_SET);
  std::vector<float> v(n);
  if (fread(v.data(), sizeof(float), n, fp) != (size_t)n) exit(1);
  fclose(fp);
  return v;
}

static std::vector<double> read_f64(const char* fn) {
  FILE* fp = fopen(fn, "rb");
  if (!fp) { fprintf(stderr, "cannot open %s\n", fn); exit(1); }
  fseek(fp, 0, SEEK_END);
  long n = ftell(fp) / (long)sizeof(double);
  fseek(fp, 0, SEEK_SET);
  std::vector<double> v(n);
  if (fread(v.data(), sizeof(double), n, fp) != (size_t)n) exit(1);
  fclose(fp);
  return v;
}

static gsl_vector* to_gsl(const std::vector<double>& v) {
  gsl_vector* g = gsl_vector_calloc(v.size());
  for (size_t i = 0; i < v.size(); i++) gsl_vector_set(g, i, v[i]);
  return g;
}

/* SampleFeature equivalent fed from memory (replicates the framing of
 * feature/feature.cc:605-646 with blockLen == shiftLen == D, padZeros=true,
 * without the libsndfile dependency). */
class RawSampleFeature : public VectorFloatFeatureStream {
 public:
  RawSampleFeature(const std::vector<float>& samples, unsigned blockLen,
                   const String& nm = "RawSample")
      : VectorFloatFeatureStream(blockLen, nm), samples_(samples), cur_(0) {}

  virtual const gsl_vector_float* next(int frame_no = -5) {
    if (frame_no == frame_no_) return vector_;
    if (cur_ >= samples_.size()) {
      is_end_ = true;
      throw jiterator_error("end of samples!");
    }
    gsl_vector_float_set_zero(vector_);
    size_t remaining = samples_.size() - cur_;
    size_t n = std::min((size_t)size(), remaining);
    for (size_t i = 0; i < n; i++) gsl_vector_float_set(vector_, i, samples_[cur_ + i]);
    cur_ += size();
    increment_();
    return vector_;
  }

  virtual void reset() {
    cur_ = 0;
    VectorFloatFeatureStream::reset();
  }

 private:
  const std::vector<float> samples_;
  size_t cur_;
};

typedef Inherit<RawSampleFeature, VectorFloatFeatureStreamPtr> RawSampleFeaturePtr;

/* pull the sink until end-of-stream, appending D samples per frame */
static void drain_to_f32(VectorFloatFeatureStreamPtr sink, unsigned D, const char* outfn) {
  FILE* fp = fopen(outfn, "wb");
  if (!fp) { fprintf(stderr, "cannot open %s\n", outfn); exit(1); }
  for (;;) {
    const gsl_vector_float* data;
    try {
      data = sink->next();
    } catch (jiterator_error&) {
      break;
    }
    for (unsigned i = 0; i < D; i++) {
      float t = gsl_vector_float_get(data, i);
      fwrite(&t, sizeof(float), 1, fp);
    }
  }
  fclose(fp);
}

/* Driver-side shim for DOAEstimatorSRPDSBLA: the reference #defines
 * __MBDEBUG__ mid-file (beamformer.cc:3138), which compiles the per-frame
 * gsl_matrix_set(rpMat_, ...) debug write into next() while the matching
 * allocDebugWorkSapce() earlier in the file stays preprocessed OUT — the
 * shipped code dereferences a NULL rpMat_ on the first voiced frame.  The
 * subclass pre-allocates the debug matrix (generously: nTheta <= 512) and
 * exposes the protected accumulated response powers. */
class SRPDriver : public DOAEstimatorSRPDSBLA {
 public:
  SRPDriver(unsigned nBest, unsigned sr, unsigned fftLen)
      : DOAEstimatorSRPDSBLA(nBest, sr, fftLen) {
    rpMat_ = gsl_matrix_calloc(512, 4);
  }
  const gsl_vector* acc_rps() const { return accRPs_; }
};

typedef Inherit<SRPDriver, DOAEstimatorSRPDSBLAPtr> SRPDriverPtr;

int main(int argc, char** argv) {
  if (argc < 2) { fprintf(stderr, "usage: %s <subcommand> ...\n", argv[0]); return 1; }
  std::string cmd = argv[1];

  if (cmd == "analysis") {
    /* analysis h.f64 M m r dc in.f32 out.c128 */
    gsl_vector* h = to_gsl(read_f64(argv[2]));
    unsigned M = atoi(argv[3]), m = atoi(argv[4]), r = atoi(argv[5]), dc = atoi(argv[6]);
    std::vector<float> x = read_f32(argv[7]);
    unsigned D = M >> r;
    RawSampleFeaturePtr src = new RawSampleFeature(x, D);
    OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
        (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
    FILE* fp = fopen(argv[8], "wb");
    for (;;) {
      const gsl_vector_complex* Y;
      try {
        Y = afb->next();
      } catch (jiterator_error&) {
        break;
      }
      for (unsigned k = 0; k < M; k++) {
        gsl_complex z = gsl_vector_complex_get(Y, k);
        fwrite(z.dat, sizeof(double), 2, fp);
      }
    }
    fclose(fp);
    return 0;
  }

  if (cmd == "recon") {
    /* recon h.f64 g.f64 M m r dc in.f32 out.f32 */
    gsl_vector* h = to_gsl(read_f64(argv[2]));
    gsl_vector* g = to_gsl(read_f64(argv[3]));
    unsigned M = atoi(argv[4]), m = atoi(argv[5]), r = atoi(argv[6]), dc = atoi(argv[7]);
    std::vector<float> x = read_f32(argv[8]);
    unsigned D = M >> r;
    RawSampleFeaturePtr src = new RawSampleFeature(x, D);
    OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
        (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
    OverSampledDFTSynthesisBankPtr sfb = new OverSampledDFTSynthesisBank(
        (VectorComplexFeatureStreamPtr&)afb, g, M, m, r, dc);
    drain_to_f32((VectorFloatFeatureStreamPtr&)sfb, D, argv[9]);
    return 0;
  }

  if (cmd == "normalfft") {
    /* normalfft M r wintype in.f32 out.c128 */
    unsigned M = atoi(argv[2]), r = atoi(argv[3]), wt = atoi(argv[4]);
    std::vector<float> x = read_f32(argv[5]);
    unsigned D = M >> r;
    RawSampleFeaturePtr src = new RawSampleFeature(x, D);
    NormalFFTAnalysisBankPtr afb = new NormalFFTAnalysisBank(
        (VectorFloatFeatureStreamPtr&)src, M, r, wt);
    FILE* fp = fopen(argv[6], "wb");
    for (;;) {
      const gsl_vector_complex* Y;
      try {
        Y = afb->next();
      } catch (jiterator_error&) {
        break;
      }
      for (unsigned k = 0; k < M; k++) {
        gsl_complex z = gsl_vector_complex_get(Y, k);
        fwrite(z.dat, sizeof(double), 2, fp);
      }
    }
    fclose(fp);
    return 0;
  }

  if (cmd == "pr_analysis" || cmd == "pr_recon") {
    /* pr_analysis h.f64 M m r in.f32 out.c128
     * pr_recon    h.f64 g.f64 M m r in.f32 out.f32 */
    int argp = 2;
    gsl_vector* h = to_gsl(read_f64(argv[argp++]));
    gsl_vector* g = NULL;
    if (cmd == "pr_recon") g = to_gsl(read_f64(argv[argp++]));
    unsigned M = atoi(argv[argp]), m = atoi(argv[argp + 1]), r = atoi(argv[argp + 2]);
    argp += 3;
    std::vector<float> x = read_f32(argv[argp++]);
    unsigned D = M >> r;
    RawSampleFeaturePtr src = new RawSampleFeature(x, D);
    PerfectReconstructionFFTAnalysisBankPtr afb =
        new PerfectReconstructionFFTAnalysisBank(
            (VectorFloatFeatureStreamPtr&)src, h, M, m, r);
    if (cmd == "pr_analysis") {
      FILE* fp = fopen(argv[argp], "wb");
      for (;;) {
        const gsl_vector_complex* Y;
        try {
          Y = afb->next();
        } catch (jiterator_error&) {
          break;
        }
        for (unsigned k = 0; k < 2 * M; k++) {
          gsl_complex z = gsl_vector_complex_get(Y, k);
          fwrite(z.dat, sizeof(double), 2, fp);
        }
      }
      fclose(fp);
      return 0;
    }
    PerfectReconstructionFFTSynthesisBankPtr sfb =
        new PerfectReconstructionFFTSynthesisBank(
            (VectorComplexFeatureStreamPtr&)afb, g, M, m, r);
    drain_to_f32((VectorFloatFeatureStreamPtr&)sfb, D, argv[argp]);
    return 0;
  }

  if (cmd == "ds" || cmd == "zelinski" || cmd == "gscrls") {
    gsl_vector* h = to_gsl(read_f64(argv[2]));
    gsl_vector* g = to_gsl(read_f64(argv[3]));
    unsigned M = atoi(argv[4]), m = atoi(argv[5]), r = atoi(argv[6]), dc = atoi(argv[7]);
    double fs = atof(argv[8]);
    gsl_vector* delays = to_gsl(read_f64(argv[9]));
    unsigned D = M >> r;
    int argp = 10;

    double alpha = 0.6; int pftype = 2, minframes = 0;
    float mu = 0.97f, sigma2 = 0.01f, qalpha = 10.0f; int qctype = 1;
    if (cmd == "zelinski") {
      alpha = atof(argv[argp++]); pftype = atoi(argv[argp++]); minframes = atoi(argv[argp++]);
    } else if (cmd == "gscrls") {
      mu = atof(argv[argp++]); sigma2 = atof(argv[argp++]);
      qalpha = atof(argv[argp++]); qctype = atoi(argv[argp++]);
    }
    const char* outfn = argv[argp++];

    std::vector<RawSampleFeaturePtr> sources;
    std::vector<OverSampledDFTAnalysisBankPtr> banks;

    SubbandDSPtr beamformer;
    SubbandGSCRLSPtr rls;
    if (cmd == "ds") {
      beamformer = new SubbandDS(M, false);
    } else if (cmd == "zelinski") {
      beamformer = new SubbandGSC(M, false);
    } else {
      rls = new SubbandGSCRLS(M, false, mu, sigma2);
      beamformer = (SubbandDSPtr&)rls;
    }

    for (; argp < argc; argp++) {
      std::vector<float> x = read_f32(argv[argp]);
      RawSampleFeaturePtr src = new RawSampleFeature(x, D);
      OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
          (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
      beamformer->set_channel((VectorComplexFeatureStreamPtr&)afb);
      sources.push_back(src);
      banks.push_back(afb);
    }

    VectorComplexFeatureStreamPtr bfout = (VectorComplexFeatureStreamPtr&)beamformer;
    ZelinskiPostFilterPtr pf;
    if (cmd == "ds") {
      beamformer->calc_array_manifold_vectors((float)fs, delays);
    } else if (cmd == "zelinski") {
      SubbandGSCPtr gsc = (SubbandGSCPtr&)beamformer;
      gsc->calc_gsc_weights((float)fs, delays);
      pf = new ZelinskiPostFilter(bfout, M, alpha, pftype, minframes);
      SubbandDSPtr bfds = (SubbandDSPtr&)beamformer;
      pf->set_beamformer(bfds);
      bfout = (VectorComplexFeatureStreamPtr&)pf;
    } else {
      rls->calc_gsc_weights((float)fs, delays);
      rls->init_precision_matrix(sigma2);
      rls->set_quadratic_constraint(qalpha, qctype);
    }

    OverSampledDFTSynthesisBankPtr sfb =
        new OverSampledDFTSynthesisBank(bfout, g, M, m, r, dc);
    drain_to_f32((VectorFloatFeatureStreamPtr&)sfb, D, outfn);
    return 0;
  }

  if (cmd == "mmi") {
    /* mmi h.f64 g.f64 M m r dc fs delays2.f64 avgfactor fwidth masktype \
     *     out.f32 in1.f32 [...]
     * SubbandMMI, 2 sources, target 0 (beamformer.cc:1704-2278):
     * calc_weights (per-source D&S mainlobes + blocking matrices),
     * use_binary_mask, drain through synthesis.  delays2.f64 is [2, C]
     * row-major. */
    gsl_vector* h = to_gsl(read_f64(argv[2]));
    gsl_vector* g = to_gsl(read_f64(argv[3]));
    unsigned M = atoi(argv[4]), m = atoi(argv[5]), r = atoi(argv[6]), dc = atoi(argv[7]);
    double fs = atof(argv[8]);
    std::vector<double> dl = read_f64(argv[9]);
    double avgfactor = atof(argv[10]);
    unsigned fwidth = atoi(argv[11]);
    unsigned masktype = atoi(argv[12]);
    const char* outfn = argv[13];
    unsigned D = M >> r;
    int argp = 14;
    unsigned chanN = argc - argp;

    gsl_matrix* delayMat = gsl_matrix_calloc(2, chanN);
    for (unsigned srcX = 0; srcX < 2; srcX++)
      for (unsigned c = 0; c < chanN; c++)
        gsl_matrix_set(delayMat, srcX, c, dl[srcX * chanN + c]);

    SubbandMMIPtr mmi = new SubbandMMI(M, false, 0, 2, 0, 0.9f);
    std::vector<RawSampleFeaturePtr> sources;
    std::vector<OverSampledDFTAnalysisBankPtr> banks;
    for (; argp < argc; argp++) {
      std::vector<float> x = read_f32(argv[argp]);
      RawSampleFeaturePtr src = new RawSampleFeature(x, D);
      OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
          (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
      mmi->set_channel((VectorComplexFeatureStreamPtr&)afb);
      sources.push_back(src);
      banks.push_back(afb);
    }
    mmi->calc_weights((float)fs, delayMat);
    mmi->use_binary_mask((float)avgfactor, fwidth, masktype);

    OverSampledDFTSynthesisBankPtr sfb = new OverSampledDFTSynthesisBank(
        (VectorComplexFeatureStreamPtr&)mmi, g, M, m, r, dc);
    drain_to_f32((VectorFloatFeatureStreamPtr&)sfb, D, outfn);
    return 0;
  }

  if (cmd == "modal" || cmd == "modal_sub") {
    /* modal     kind h.f64 g.f64 M m r dc fs maxorder sigma2 wgain theta phi \
     *           out.f32 in1.f32 [... 32 channels]
     * modal_sub kind h.f64 M m r dc fs maxorder sigma2 wgain theta phi \
     *           out.c128 in1.f32 [...]
     * Spherical-harmonic beamformers on the Eigenmike geometry
     * (modalbeamformer.cc): kind = eigen | sphds (EigenBeamformer /
     * SphericalDSBeamformer). */
    std::string kind = argv[2];
    int argp = 3;
    gsl_vector* h = to_gsl(read_f64(argv[argp++]));
    gsl_vector* g = NULL;
    bool subband = (cmd == "modal_sub");
    if (!subband) g = to_gsl(read_f64(argv[argp++]));
    unsigned M = atoi(argv[argp]), m = atoi(argv[argp + 1]), r = atoi(argv[argp + 2]),
             dc = atoi(argv[argp + 3]);
    argp += 4;
    double fs = atof(argv[argp++]);
    unsigned maxorder = atoi(argv[argp++]);
    double sigma2 = atof(argv[argp++]);
    double wgain = atof(argv[argp++]);
    double theta = atof(argv[argp++]);
    double phi = atof(argv[argp++]);
    const char* outfn = argv[argp++];
    unsigned D = M >> r;

    EigenBeamformerPtr bf;
    SphericalGSCBeamformer* gsc_raw = NULL;
    if (kind == "eigen")
      bf = new EigenBeamformer((unsigned)fs, M, false, 1, maxorder, false);
    else if (kind == "sphds")
      bf = (EigenBeamformerPtr)new SphericalDSBeamformer((unsigned)fs, M, false, 1, maxorder, false);
    else if (kind == "hwnc")
      bf = (EigenBeamformerPtr)new SphericalHWNCBeamformer((unsigned)fs, M, false, 1, maxorder, false);
    else if (kind == "sphgsc") {
      gsc_raw = new SphericalGSCBeamformer((unsigned)fs, M, false, 1, maxorder, false);
      bf = (EigenBeamformerPtr)gsc_raw;
    } else if (kind == "moen") {
      /* Deterministic diagonal loading: without it the reference
       * pseudo-inverts the FLOAT-noise singular values of the
       * rank-deficient A^H A (abs threshold 1e-8 keeps them,
       * beamformer.cc:263-270) — unreproducible junk weights. */
      SphericalMOENBeamformer* p =
          new SphericalMOENBeamformer((unsigned)fs, M, false, 1, maxorder, false);
      for (unsigned fb = 0; fb <= M / 2; fb++) p->set_diagonal_looading(fb, 1.0f);
      bf = (EigenBeamformerPtr)p;
    } else if (kind == "spatialds")
      bf = (EigenBeamformerPtr)new SphericalSpatialDSBeamformer((unsigned)fs, M, false, 1, maxorder, false);
    else { fprintf(stderr, "unknown modal kind %s\n", kind.c_str()); return 1; }
    bf->set_sigma2((float)sigma2);
    bf->set_weight_gain((float)wgain);

    std::vector<RawSampleFeaturePtr> sources;
    std::vector<OverSampledDFTAnalysisBankPtr> banks;
    for (; argp < argc; argp++) {
      std::vector<float> x = read_f32(argv[argp]);
      RawSampleFeaturePtr src = new RawSampleFeature(x, D);
      OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
          (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
      bf->set_channel((VectorComplexFeatureStreamPtr&)afb);
      sources.push_back(src);
      banks.push_back(afb);
    }
    bf->set_eigenmike_geometry();
    bf->set_look_direction(theta, phi);

    if (gsc_raw != NULL) {
      /* deterministic nonzero lower-branch weights so the golden exercises
       * the full GSC path y = (wq - B wa)^H F, not just the quiescent
       * branch (set_active_weights_f -> calcSidelobeCancellerP_f,
       * interleaved re/im, length 2*(dim - NC)). */
      unsigned dim = maxorder * maxorder;
      gsl_vector* pw = gsl_vector_calloc(2 * (dim - 1));
      for (unsigned fb = 1; fb <= M / 2; fb++) {
        for (unsigned k = 0; k < dim - 1; k++) {
          gsl_vector_set(pw, 2 * k, 0.1 * sin(0.37 * fb + (double)k));
          gsl_vector_set(pw, 2 * k + 1, 0.1 * cos(0.23 * fb + 0.5 * (double)k));
        }
        gsc_raw->set_active_weights_f(fb, pw);
      }
      gsl_vector_free(pw);
    }

    if (subband) {
      FILE* fp = fopen(outfn, "wb");
      for (;;) {
        const gsl_vector_complex* Y;
        try {
          Y = bf->next();
        } catch (jiterator_error&) {
          break;
        }
        for (unsigned k = 0; k < M; k++) {
          gsl_complex z = gsl_vector_complex_get(Y, k);
          fwrite(z.dat, sizeof(double), 2, fp);
        }
      }
      fclose(fp);
      return 0;
    }
    OverSampledDFTSynthesisBankPtr sfb = new OverSampledDFTSynthesisBank(
        (VectorComplexFeatureStreamPtr&)bf, g, M, m, r, dc);
    drain_to_f32((VectorFloatFeatureStreamPtr&)sfb, D, outfn);
    return 0;
  }

  if (cmd == "shfuncs") {
    /* shfuncs maxorder ngrid out.f64
     * The spherical tracker's static observation-model functions
     * (BaseDecomposition::harmonic + its theta/phi derivatives,
     * tracker.cc:305-430) over an (order, degree, theta, phi) grid:
     * rows [order, degree, theta, phi, reY, imY, reDt, imDt, reDp, imDp]. */
    int maxorder = atoi(argv[2]);
    int ngrid = atoi(argv[3]);
    FILE* fp = fopen(argv[4], "wb");
    for (int n = 0; n < maxorder; n++) {
      for (int m = -n; m <= n; m++) {
        for (int i = 0; i < ngrid; i++) {
          double theta = 0.15 + (M_PI - 0.3) * i / (double)(ngrid - 1);
          double phi = -2.5 + 5.0 * i / (double)(ngrid - 1);
          gsl_complex Y = BaseDecomposition::harmonic(n, m, theta, phi);
          gsl_complex Dt = BaseDecomposition::harmonic_deriv_polar_angle(n, m, theta, phi);
          gsl_complex Dp = BaseDecomposition::harmonic_deriv_azimuth(n, m, theta, phi);
          double row[10] = {(double)n, (double)m, theta, phi,
                            GSL_REAL(Y), GSL_IMAG(Y), GSL_REAL(Dt), GSL_IMAG(Dt),
                            GSL_REAL(Dp), GSL_IMAG(Dp)};
          fwrite(row, sizeof(double), 10, fp);
        }
      }
    }
    fclose(fp);
    return 0;
  }

  if (cmd == "zelinski_sub") {
    /* zelinski_sub h.f64 M m r dc fs delays.f64 alpha pftype minframes \
     *             out.c128 in1.f32 [...]
     * GSC + Zelinski postfilter SUBBAND output (no synthesis bank):
     * localizes postfilter-domain deviations per frame/bin. */
    gsl_vector* h = to_gsl(read_f64(argv[2]));
    unsigned M = atoi(argv[3]), m = atoi(argv[4]), r = atoi(argv[5]), dc = atoi(argv[6]);
    double fs = atof(argv[7]);
    gsl_vector* delays = to_gsl(read_f64(argv[8]));
    double alpha = atof(argv[9]); int pftype = atoi(argv[10]), minframes = atoi(argv[11]);
    const char* outfn = argv[12];
    unsigned D = M >> r;
    int argp = 13;

    SubbandGSCPtr beamformer = new SubbandGSC(M, false);
    std::vector<RawSampleFeaturePtr> sources;
    std::vector<OverSampledDFTAnalysisBankPtr> banks;
    for (; argp < argc; argp++) {
      std::vector<float> x = read_f32(argv[argp]);
      RawSampleFeaturePtr src = new RawSampleFeature(x, D);
      OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
          (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
      beamformer->set_channel((VectorComplexFeatureStreamPtr&)afb);
      sources.push_back(src);
      banks.push_back(afb);
    }
    beamformer->calc_gsc_weights((float)fs, delays);
    VectorComplexFeatureStreamPtr bfout = (VectorComplexFeatureStreamPtr&)beamformer;
    ZelinskiPostFilterPtr pf = new ZelinskiPostFilter(bfout, M, alpha, pftype, minframes);
    SubbandDSPtr bfds = (SubbandDSPtr&)beamformer;
    pf->set_beamformer(bfds);
    FILE* fp = fopen(outfn, "wb");
    /* optional: dump the snapshot array the postfilter reads (all bins x
     * channels per frame) to <outfn>.snap for deviation localization */
    char snapfn[4096];
    snprintf(snapfn, sizeof(snapfn), "%s.snap", outfn);
    FILE* sfp = fopen(snapfn, "wb");
    unsigned chanN = beamformer->chanN();
    for (;;) {
      const gsl_vector_complex* Y;
      try {
        Y = pf->next();
      } catch (jiterator_error&) {
        break;
      }
      for (unsigned k = 0; k < M; k++) {
        gsl_complex z = gsl_vector_complex_get(Y, k);
        fwrite(z.dat, sizeof(double), 2, fp);
      }
      (void)chanN;
      const gsl_vector_complex* wp1 =
          beamformer->beamformer_weight_object(0)->wp1();
      for (unsigned k = 0; k < M; k++) {
        gsl_complex z = gsl_vector_complex_get(wp1, k);
        fwrite(z.dat, sizeof(double), 2, sfp);
      }
    }
    fclose(fp);
    fclose(sfp);
    return 0;
  }

  if (cmd == "srp") {
    /* srp nbest h.f64 M m r dc fs ethresh xpos.f64 accout.f64 nbestout.f64 \
     *     in1.f32 [...]
     * DOAEstimatorSRPDSBLA: per-frame energy-gated D&S response powers
     * accumulated over the utterance, N-best from the accumulated powers
     * (beamformer.cc:3125-3197).  Dumps accRPs [G] and then the N-best
     * (rp, theta) rows after final_nbest_hypotheses(). */
    unsigned nbest = atoi(argv[2]);
    gsl_vector* h = to_gsl(read_f64(argv[3]));
    unsigned M = atoi(argv[4]), m = atoi(argv[5]), r = atoi(argv[6]), dc = atoi(argv[7]);
    double fs = atof(argv[8]);
    double ethresh = atof(argv[9]);
    std::vector<double> xposv = read_f64(argv[10]);
    const char* accfn = argv[11];
    const char* nbestfn = argv[12];
    const char* enfn = argv[13];
    unsigned D = M >> r;
    int argp = 14;

    gsl_vector* xpos = to_gsl(xposv);
    SRPDriverPtr doa = new SRPDriver(nbest, (unsigned)fs, M);
    doa->set_array_geometry(xpos);
    doa->set_energy_threshold((float)ethresh);
    std::vector<RawSampleFeaturePtr> sources;
    std::vector<OverSampledDFTAnalysisBankPtr> banks;
    for (; argp < argc; argp++) {
      std::vector<float> x = read_f32(argv[argp]);
      RawSampleFeaturePtr src = new RawSampleFeature(x, D);
      OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
          (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
      doa->set_channel((VectorComplexFeatureStreamPtr&)afb);
      sources.push_back(src);
      banks.push_back(afb);
    }
    FILE* efp = fopen(enfn, "wb");
    for (;;) {
      try {
        doa->next();
      } catch (jiterator_error&) {
        break;
      }
      double e = doa->energy();
      fwrite(&e, sizeof(double), 1, efp);
    }
    fclose(efp);
    doa->final_nbest_hypotheses();

    const gsl_vector* acc = doa->acc_rps();
    FILE* fp = fopen(accfn, "wb");
    for (unsigned i = 0; i < acc->size; i++) {
      double v = gsl_vector_get(acc, i);
      fwrite(&v, sizeof(double), 1, fp);
    }
    fclose(fp);
    const gsl_vector* rps = doa->nbest_rps();
    const gsl_matrix* doas = doa->nbest_doas();
    fp = fopen(nbestfn, "wb");
    for (unsigned n = 0; n < nbest; n++) {
      double row[3] = {gsl_vector_get(rps, n), gsl_matrix_get(doas, n, 0),
                       gsl_matrix_get(doas, n, 1)};
      fwrite(row, sizeof(double), 3, fp);
    }
    fclose(fp);
    return 0;
  }

  if (cmd == "gscpf") {
    /* gscpf kind h.f64 g.f64 M m r dc fs delays.f64 micpos.f64 \
     *       alpha pftype minframes dload minsv fbin1 out.f32 in1.f32 [...]
     * GSC quiescent branch + McCowan or Lefkimmiatis postfilter (the
     * coherence-based Wiener family, postfilter.h:123-202). */
    std::string kind = argv[2];
    gsl_vector* h = to_gsl(read_f64(argv[3]));
    gsl_vector* g = to_gsl(read_f64(argv[4]));
    unsigned M = atoi(argv[5]), m = atoi(argv[6]), r = atoi(argv[7]), dc = atoi(argv[8]);
    double fs = atof(argv[9]);
    gsl_vector* delays = to_gsl(read_f64(argv[10]));
    std::vector<double> mposv = read_f64(argv[11]);
    double alpha = atof(argv[12]); int pftype = atoi(argv[13]), minframes = atoi(argv[14]);
    double dload = atof(argv[15]), minsv = atof(argv[16]);
    unsigned fbin1 = atoi(argv[17]);
    const char* outfn = argv[18];
    unsigned D = M >> r;
    int argp = 19;

    unsigned chanN = argc - argp;
    gsl_matrix* mpos = gsl_matrix_calloc(chanN, 3);
    for (unsigned c = 0; c < chanN; c++)
      for (unsigned k = 0; k < 3; k++)
        gsl_matrix_set(mpos, c, k, mposv[3 * c + k]);

    SubbandGSCPtr beamformer = new SubbandGSC(M, false);
    std::vector<RawSampleFeaturePtr> sources;
    std::vector<OverSampledDFTAnalysisBankPtr> banks;
    for (; argp < argc; argp++) {
      std::vector<float> x = read_f32(argv[argp]);
      RawSampleFeaturePtr src = new RawSampleFeature(x, D);
      OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
          (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
      beamformer->set_channel((VectorComplexFeatureStreamPtr&)afb);
      sources.push_back(src);
      banks.push_back(afb);
    }
    beamformer->calc_gsc_weights((float)fs, delays);

    VectorComplexFeatureStreamPtr bfout = (VectorComplexFeatureStreamPtr&)beamformer;
    SubbandDSPtr bfds = (SubbandDSPtr&)beamformer;
    McCowanPostFilterPtr mc;
    LefkimmiatisPostFilterPtr lk;
    if (kind == "mccowan") {
      mc = new McCowanPostFilter(bfout, M, alpha, pftype, minframes);
      mc->set_diffuse_noise_model(mpos, fs);
      mc->set_all_diagonal_loading((float)dload);
      mc->set_beamformer(bfds);
      bfout = (VectorComplexFeatureStreamPtr&)mc;
    } else if (kind == "lefkimmiatis") {
      lk = new LefkimmiatisPostFilter(bfout, M, minsv, fbin1, alpha, pftype,
                                      minframes);
      lk->set_diffuse_noise_model(mpos, fs);
      lk->set_all_diagonal_loading((float)dload);
      lk->calc_inverse_noise_spatial_spectral_matrix();
      lk->set_beamformer(bfds);
      bfout = (VectorComplexFeatureStreamPtr&)lk;
    } else {
      fprintf(stderr, "unknown gscpf kind %s\n", kind.c_str());
      return 1;
    }
    OverSampledDFTSynthesisBankPtr sfb =
        new OverSampledDFTSynthesisBank(bfout, g, M, m, r, dc);
    drain_to_f32((VectorFloatFeatureStreamPtr&)sfb, D, outfn);
    return 0;
  }

  if (cmd == "sdmvdr") {
    /* sdmvdr h.f64 g.f64 M m r dc fs delays.f64 micpos.f64 mu \
     *        alpha pftype minframes out.f32 in1.f32 [...]
     * Super-directive MVDR (diffuse-noise model + diagonal loading) with an
     * optional Zelinski postfilter (pftype < 0 disables it) — BASELINE
     * config 2.  micpos.f64 is [C,3] row-major. */
    gsl_vector* h = to_gsl(read_f64(argv[2]));
    gsl_vector* g = to_gsl(read_f64(argv[3]));
    unsigned M = atoi(argv[4]), m = atoi(argv[5]), r = atoi(argv[6]), dc = atoi(argv[7]);
    double fs = atof(argv[8]);
    gsl_vector* delays = to_gsl(read_f64(argv[9]));
    std::vector<double> mposv = read_f64(argv[10]);
    double mu = atof(argv[11]);
    double alpha = atof(argv[12]); int pftype = atoi(argv[13]), minframes = atoi(argv[14]);
    const char* outfn = argv[15];
    unsigned D = M >> r;
    int argp = 16;

    unsigned chanN = argc - argp;
    gsl_matrix* mpos = gsl_matrix_calloc(chanN, 3);
    for (unsigned c = 0; c < chanN; c++)
      for (unsigned k = 0; k < 3; k++)
        gsl_matrix_set(mpos, c, k, mposv[3 * c + k]);

    SubbandMVDRPtr beamformer = new SubbandMVDR(M, false);
    std::vector<RawSampleFeaturePtr> sources;
    std::vector<OverSampledDFTAnalysisBankPtr> banks;
    for (; argp < argc; argp++) {
      std::vector<float> x = read_f32(argv[argp]);
      RawSampleFeaturePtr src = new RawSampleFeature(x, D);
      OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
          (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
      beamformer->set_channel((VectorComplexFeatureStreamPtr&)afb);
      sources.push_back(src);
      banks.push_back(afb);
    }
    beamformer->calc_array_manifold_vectors((float)fs, delays);
    beamformer->set_diffuse_noise_model(mpos, (float)fs);
    beamformer->set_all_diagonal_loading((float)mu);
    beamformer->calc_mvdr_weights((float)fs);

    VectorComplexFeatureStreamPtr bfout = (VectorComplexFeatureStreamPtr&)beamformer;
    ZelinskiPostFilterPtr pf;
    if (pftype >= 0) {
      pf = new ZelinskiPostFilter(bfout, M, alpha, pftype, minframes);
      SubbandDSPtr bfds = (SubbandDSPtr&)beamformer;
      pf->set_beamformer(bfds);
      bfout = (VectorComplexFeatureStreamPtr&)pf;
    }
    OverSampledDFTSynthesisBankPtr sfb =
        new OverSampledDFTSynthesisBank(bfout, g, M, m, r, dc);
    drain_to_f32((VectorFloatFeatureStreamPtr&)sfb, D, outfn);
    return 0;
  }

  if (cmd == "wpe") {
    /* wpe h.f64 g.f64 M m r dc lowerN upperN iters loadDb bandWidth fs
     *     in.f32 out.f32 */
    gsl_vector* h = to_gsl(read_f64(argv[2]));
    gsl_vector* g = to_gsl(read_f64(argv[3]));
    unsigned M = atoi(argv[4]), m = atoi(argv[5]), r = atoi(argv[6]), dc = atoi(argv[7]);
    unsigned lowerN = atoi(argv[8]), upperN = atoi(argv[9]), iters = atoi(argv[10]);
    double loadDb = atof(argv[11]), bandWidth = atof(argv[12]), fs = atof(argv[13]);
    std::vector<float> x = read_f32(argv[14]);
    unsigned D = M >> r;
    RawSampleFeaturePtr src = new RawSampleFeature(x, D);
    OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
        (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
    SingleChannelWPEDereverberationFeaturePtr wpe =
        new SingleChannelWPEDereverberationFeature(
            (VectorComplexFeatureStreamPtr&)afb, lowerN, upperN, iters, loadDb,
            bandWidth, fs);
    /* two-pass protocol per test_subband_dereverberator.py:73-84:
     * estimate over the whole utterance (resets the source), then stream */
    wpe->estimate_filter();
    OverSampledDFTSynthesisBankPtr sfb = new OverSampledDFTSynthesisBank(
        (VectorComplexFeatureStreamPtr&)wpe, g, M, m, r, dc);
    drain_to_f32((VectorFloatFeatureStreamPtr&)sfb, D, argv[15]);
    return 0;
  }

  if (cmd == "wpemc") {
    /* wpemc h.f64 g.f64 M m r dc lowerN upperN iters loadDb bandWidth fs
     *       outprefix in1.f32 [in2.f32 ...]   -> outprefix<ch>.f32 */
    gsl_vector* h = to_gsl(read_f64(argv[2]));
    gsl_vector* g = to_gsl(read_f64(argv[3]));
    unsigned M = atoi(argv[4]), m = atoi(argv[5]), r = atoi(argv[6]), dc = atoi(argv[7]);
    unsigned lowerN = atoi(argv[8]), upperN = atoi(argv[9]), iters = atoi(argv[10]);
    double loadDb = atof(argv[11]), bandWidth = atof(argv[12]), fs = atof(argv[13]);
    const char* outprefix = argv[14];
    unsigned D = M >> r;
    unsigned chanN = argc - 15;
    MultiChannelWPEDereverberationPtr wpe = new MultiChannelWPEDereverberation(
        M, chanN, lowerN, upperN, iters, loadDb, bandWidth, 0.0, fs);
    for (unsigned c = 0; c < chanN; c++) {
      std::vector<float> x = read_f32(argv[15 + c]);
      RawSampleFeaturePtr src = new RawSampleFeature(x, D);
      OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
          (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
      VectorComplexFeatureStreamPtr afbc = (VectorComplexFeatureStreamPtr&)afb;
      wpe->set_input(afbc);
    }
    wpe->estimate_filter();
    std::vector<OverSampledDFTSynthesisBankPtr> sfbs;
    std::vector<FILE*> fps;
    for (unsigned c = 0; c < chanN; c++) {
      MultiChannelWPEDereverberationFeaturePtr feat =
          new MultiChannelWPEDereverberationFeature(wpe, c, 0);
      sfbs.push_back(new OverSampledDFTSynthesisBank(
          (VectorComplexFeatureStreamPtr&)feat, g, M, m, r, dc));
      char fn[4096];
      snprintf(fn, sizeof(fn), "%s%u.f32", outprefix, c);
      fps.push_back(fopen(fn, "wb"));
    }
    for (;;) {
      bool done = false;
      for (unsigned c = 0; c < chanN; c++) {
        const gsl_vector_float* data;
        try {
          data = sfbs[c]->next();
        } catch (jiterator_error&) {
          done = true;
          break;
        }
        for (unsigned i = 0; i < D; i++) {
          float t = gsl_vector_float_get(data, i);
          fwrite(&t, sizeof(float), 1, fps[c]);
        }
      }
      if (done) break;
    }
    for (FILE* fp : fps) fclose(fp);
    return 0;
  }

  if (cmd == "wpemc_sub") {
    /* wpemc_sub h.f64 M m r dc lowerN upperN iters loadDb bandWidth fs
     *           outprefix in1.f32 [...]  -> per-channel subband frames
     * (calc_every_channel_output driven directly: isolates the WPE math
     * from the synthesis-bank priming interleave of the full driver) */
    gsl_vector* h = to_gsl(read_f64(argv[2]));
    unsigned M = atoi(argv[3]), m = atoi(argv[4]), r = atoi(argv[5]), dc = atoi(argv[6]);
    unsigned lowerN = atoi(argv[7]), upperN = atoi(argv[8]), iters = atoi(argv[9]);
    double loadDb = atof(argv[10]), bandWidth = atof(argv[11]), fs = atof(argv[12]);
    const char* outprefix = argv[13];
    unsigned D = M >> r;
    unsigned chanN = argc - 14;
    MultiChannelWPEDereverberation wpe(M, chanN, lowerN, upperN, iters, loadDb,
                                       bandWidth, 0.0, fs);
    for (unsigned c = 0; c < chanN; c++) {
      std::vector<float> x = read_f32(argv[14 + c]);
      RawSampleFeaturePtr src = new RawSampleFeature(x, D);
      OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
          (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
      VectorComplexFeatureStreamPtr afbc = (VectorComplexFeatureStreamPtr&)afb;
      wpe.set_input(afbc);
    }
    wpe.estimate_filter();
    std::vector<FILE*> fps;
    for (unsigned c = 0; c < chanN; c++) {
      char fn[4096];
      snprintf(fn, sizeof(fn), "%s%u.c128", outprefix, c);
      fps.push_back(fopen(fn, "wb"));
    }
    for (;;) {
      gsl_vector_complex** out;
      try {
        out = wpe.calc_every_channel_output();
      } catch (jiterator_error&) {
        break;
      }
      for (unsigned c = 0; c < chanN; c++)
        for (unsigned k = 0; k < M; k++) {
          gsl_complex z = gsl_vector_complex_get(out[c], k);
          fwrite(z.dat, sizeof(double), 2, fps[c]);
        }
    }
    for (FILE* fp : fps) fclose(fp);
    return 0;
  }

  if (cmd == "aec") {
    /* aec kind h.f64 g.f64 M m r dc p1 p2 p3 play.f32 rec.f32 out.f32
     *   kind=nlms:   p1=delta  p2=epsilon p3=threshold
     *   kind=kalman: p1=beta   p2=sigma2  p3=threshold */
    std::string kind = argv[2];
    gsl_vector* h = to_gsl(read_f64(argv[3]));
    gsl_vector* g = to_gsl(read_f64(argv[4]));
    unsigned M = atoi(argv[5]), m = atoi(argv[6]), r = atoi(argv[7]), dc = atoi(argv[8]);
    double p1 = atof(argv[9]), p2 = atof(argv[10]), p3 = atof(argv[11]);
    std::vector<float> vplay = read_f32(argv[12]);
    std::vector<float> vrec = read_f32(argv[13]);
    unsigned D = M >> r;
    RawSampleFeaturePtr psrc = new RawSampleFeature(vplay, D);
    RawSampleFeaturePtr rsrc = new RawSampleFeature(vrec, D);
    OverSampledDFTAnalysisBankPtr pafb = new OverSampledDFTAnalysisBank(
        (VectorFloatFeatureStreamPtr&)psrc, h, M, m, r, dc);
    OverSampledDFTAnalysisBankPtr rafb = new OverSampledDFTAnalysisBank(
        (VectorFloatFeatureStreamPtr&)rsrc, h, M, m, r, dc);
    VectorComplexFeatureStreamPtr pstr = (VectorComplexFeatureStreamPtr&)pafb;
    VectorComplexFeatureStreamPtr rstr = (VectorComplexFeatureStreamPtr&)rafb;
    VectorComplexFeatureStreamPtr aec;
    if (kind == "nlms")
      aec = new NLMSAcousticEchoCancellationFeature(pstr, rstr, p1, p2, p3);
    else if (kind == "kalman")
      aec = new KalmanFilterEchoCancellationFeature(pstr, rstr, p1, p2, p3);
    else {
      fprintf(stderr, "unknown aec kind %s\n", kind.c_str());
      return 1;
    }
    OverSampledDFTSynthesisBankPtr sfb =
        new OverSampledDFTSynthesisBank(aec, g, M, m, r, dc);
    drain_to_f32((VectorFloatFeatureStreamPtr&)sfb, D, argv[14]);
    return 0;
  }

  if (cmd == "sqrtkern") {
    /* sqrtkern n in.f64 out.f64
     * Drives the square_root/ kernels (square_root.cc) on packed inputs:
     *   in:  L [n,n] c128 (lower factor), rhs [n] c128, alpha (1 f64),
     *        c [n] c128, a12 [n] c128, a21 [n] c128, a22 (c128),
     *        dim (1 f64), wght (1 f64)
     *   out: fwd(false) [n], fwd(true) [n], back(false) [n], back(true) [n]
     *        (all c128), rank1-updated L [n,n], info-rls L' [n,n] and
     *        a21' [n], diag-loaded L'' [n,n]. */
    unsigned n = atoi(argv[2]);
    std::vector<double> in = read_f64(argv[3]);
    size_t off = 0;
    gsl_matrix_complex* L = gsl_matrix_complex_calloc(n, n);
    for (unsigned i = 0; i < n; i++)
      for (unsigned j = 0; j < n; j++) {
        gsl_matrix_complex_set(L, i, j, gsl_complex_rect(in[off], in[off + 1]));
        off += 2;
      }
    gsl_vector_complex* rhs = gsl_vector_complex_calloc(n);
    for (unsigned i = 0; i < n; i++) {
      gsl_vector_complex_set(rhs, i, gsl_complex_rect(in[off], in[off + 1]));
      off += 2;
    }
    double alpha = in[off++];
    gsl_vector_complex* c = gsl_vector_complex_calloc(n);
    for (unsigned i = 0; i < n; i++) {
      gsl_vector_complex_set(c, i, gsl_complex_rect(in[off], in[off + 1]));
      off += 2;
    }
    gsl_vector_complex* a12 = gsl_vector_complex_calloc(n);
    for (unsigned i = 0; i < n; i++) {
      gsl_vector_complex_set(a12, i, gsl_complex_rect(in[off], in[off + 1]));
      off += 2;
    }
    gsl_vector_complex* a21 = gsl_vector_complex_calloc(n);
    for (unsigned i = 0; i < n; i++) {
      gsl_vector_complex_set(a21, i, gsl_complex_rect(in[off], in[off + 1]));
      off += 2;
    }
    gsl_complex a22 = gsl_complex_rect(in[off], in[off + 1]);
    off += 2;
    int dimload = (int)in[off++];
    double wght = in[off++];

    FILE* fp = fopen(argv[4], "wb");
    gsl_vector_complex* out = gsl_vector_complex_calloc(n);
    auto wv = [&](const gsl_vector_complex* v) {
      for (unsigned i = 0; i < n; i++) {
        gsl_complex z = gsl_vector_complex_get(v, i);
        fwrite(z.dat, sizeof(double), 2, fp);
      }
    };
    auto wm = [&](const gsl_matrix_complex* m) {
      for (unsigned i = 0; i < n; i++)
        for (unsigned j = 0; j < n; j++) {
          gsl_complex z = gsl_matrix_complex_get(m, i, j);
          fwrite(z.dat, sizeof(double), 2, fp);
        }
    };
    cholesky_forwardsub_complex(L, rhs, out, false);  wv(out);
    cholesky_forwardsub_complex(L, rhs, out, true);   wv(out);
    cholesky_backsub_complex(L, rhs, out, false);     wv(out);
    cholesky_backsub_complex(L, rhs, out, true);      wv(out);

    gsl_matrix_complex* L1 = gsl_matrix_complex_calloc(n, n);
    gsl_matrix_complex_memcpy(L1, L);
    rank_one_update_cholesky_factor(L1, alpha, c);
    wm(L1);

    gsl_matrix_complex* L2 = gsl_matrix_complex_calloc(n, n);
    gsl_matrix_complex_memcpy(L2, L);
    gsl_vector_complex* a12c = gsl_vector_complex_calloc(n);
    gsl_vector_complex* a21c = gsl_vector_complex_calloc(n);
    gsl_vector_complex_memcpy(a12c, a12);
    gsl_vector_complex_memcpy(a21c, a21);
    propagate_info_square_root_rls(L2, a12c, a21c, a22);
    wm(L2);
    wv(a21c);

    gsl_matrix_complex* L3 = gsl_matrix_complex_calloc(n, n);
    gsl_matrix_complex_memcpy(L3, L);
    add_diagonal_loading(L3, dimload, wght);
    wm(L3);
    fclose(fp);
    return 0;
  }

  if (cmd == "modal_dual" || cmd == "modal_sub2") {
    /* modal_dual kind(dualds|dualgsc) h.f64 M m r dc fs maxorder sigma2 \
     *            wgain theta phi sub_out.c128 wq2_out.c128 in1.f32 [...]
     *   -> subband output + the secondary ELEMENT-domain D&S weights
     *      (bfweight_vec2_, DualSpherical*Beamformer)
     * modal_sub2 kind(hwncgsc|spatialhwnc) h.f64 M m r dc fs maxorder \
     *            sigma2 wgain theta phi out.c128 in1.f32 [...] */
    std::string kind = argv[2];
    int argp = 3;
    gsl_vector* h = to_gsl(read_f64(argv[argp++]));
    unsigned M = atoi(argv[argp]), m = atoi(argv[argp + 1]), r = atoi(argv[argp + 2]),
             dc = atoi(argv[argp + 3]);
    argp += 4;
    double fs = atof(argv[argp++]);
    unsigned maxorder = atoi(argv[argp++]);
    double sigma2 = atof(argv[argp++]);
    double wgain = atof(argv[argp++]);
    double theta = atof(argv[argp++]);
    double phi = atof(argv[argp++]);
    const char* outfn = argv[argp++];
    const char* wq2fn = NULL;
    if (cmd == "modal_dual") wq2fn = argv[argp++];
    unsigned D = M >> r;

    EigenBeamformerPtr bf;
    DualSphericalDSBeamformer* dual_ds = NULL;
    DualSphericalGSCBeamformer* dual_gsc = NULL;
    SphericalHWNCGSCBeamformer* hwnc_gsc = NULL;
    if (kind == "dualds") {
      dual_ds = new DualSphericalDSBeamformer((unsigned)fs, M, false, 1, maxorder, false);
      bf = (EigenBeamformerPtr)dual_ds;
    } else if (kind == "dualgsc") {
      dual_gsc = new DualSphericalGSCBeamformer((unsigned)fs, M, false, 1, maxorder, false);
      bf = (EigenBeamformerPtr)dual_gsc;
    } else if (kind == "hwncgsc") {
      hwnc_gsc = new SphericalHWNCGSCBeamformer((unsigned)fs, M, false, 1, maxorder, false);
      bf = (EigenBeamformerPtr)hwnc_gsc;
    } else if (kind == "spatialhwnc") {
      bf = (EigenBeamformerPtr)new SphericalSpatialHWNCBeamformer(
          (unsigned)fs, M, false, 1, maxorder, false);
    } else { fprintf(stderr, "unknown kind %s\n", kind.c_str()); return 1; }
    bf->set_sigma2((float)sigma2);
    bf->set_weight_gain((float)wgain);

    std::vector<RawSampleFeaturePtr> sources;
    std::vector<OverSampledDFTAnalysisBankPtr> banks;
    for (; argp < argc; argp++) {
      std::vector<float> x = read_f32(argv[argp]);
      RawSampleFeaturePtr src = new RawSampleFeature(x, D);
      OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
          (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
      bf->set_channel((VectorComplexFeatureStreamPtr&)afb);
      sources.push_back(src);
      banks.push_back(afb);
    }
    bf->set_eigenmike_geometry();
    bf->set_look_direction(theta, phi);

    if (dual_gsc != NULL || hwnc_gsc != NULL) {
      /* deterministic nonzero lower-branch weights (see the sphgsc note) */
      unsigned dim = maxorder * maxorder;
      gsl_vector* pw = gsl_vector_calloc(2 * (dim - 1));
      for (unsigned fb = 1; fb <= M / 2; fb++) {
        for (unsigned k = 0; k < dim - 1; k++) {
          gsl_vector_set(pw, 2 * k, 0.1 * sin(0.37 * fb + (double)k));
          gsl_vector_set(pw, 2 * k + 1, 0.1 * cos(0.23 * fb + 0.5 * (double)k));
        }
        if (dual_gsc) dual_gsc->set_active_weights_f(fb, pw);
        else hwnc_gsc->set_active_weights_f(fb, pw);
      }
      gsl_vector_free(pw);
    }

    FILE* fp = fopen(outfn, "wb");
    for (;;) {
      const gsl_vector_complex* Y;
      try {
        Y = bf->next();
      } catch (jiterator_error&) {
        break;
      }
      for (unsigned k = 0; k < M; k++) {
        gsl_complex z = gsl_vector_complex_get(Y, k);
        fwrite(z.dat, sizeof(double), 2, fp);
      }
    }
    fclose(fp);
    if (wq2fn != NULL) {
      BeamformerWeights* w2 = (dual_ds != NULL)
          ? dual_ds->beamformer_weight_object(0)
          : dual_gsc->beamformer_weight_object(0);
      FILE* f2 = fopen(wq2fn, "wb");
      unsigned C = bf->chanN();
      for (unsigned fb = 0; fb <= M / 2; fb++) {
        gsl_vector_complex* wq = w2->wq_f(fb);
        for (unsigned c = 0; c < C; c++) {
          gsl_complex z = gsl_vector_complex_get(wq, c);
          fwrite(z.dat, sizeof(double), 2, f2);
        }
      }
      fclose(f2);
    }
    return 0;
  }

  if (cmd == "modal_srp") {
    /* modal_srp kind(srpeb|srpsphdsb) h.f64 M m r dc fs maxorder nbest \
     *           minT maxT minP maxP wT wP nframes out.f64 in1.f32 [...]
     * Processes exactly nframes frames (so accRPs is frame-aligned with
     * the python side); dumps accRPs [G], then the LAST frame's
     * nbest_rps [nbest] and nbest_doas [nbest, 2]. */
    std::string kind = argv[2];
    int argp = 3;
    gsl_vector* h = to_gsl(read_f64(argv[argp++]));
    unsigned M = atoi(argv[argp]), m = atoi(argv[argp + 1]), r = atoi(argv[argp + 2]),
             dc = atoi(argv[argp + 3]);
    argp += 4;
    double fs = atof(argv[argp++]);
    unsigned maxorder = atoi(argv[argp++]);
    unsigned nbest = atoi(argv[argp++]);
    double minT = atof(argv[argp++]), maxT = atof(argv[argp++]);
    double minP = atof(argv[argp++]), maxP = atof(argv[argp++]);
    double wT = atof(argv[argp++]), wP = atof(argv[argp++]);
    int nframes = atoi(argv[argp++]);
    const char* outfn = argv[argp++];
    unsigned D = M >> r;

    class SRPEBDriver : public DOAEstimatorSRPEB {
     public:
      SRPEBDriver(unsigned nB, unsigned sr, unsigned fftLen, unsigned maxOrder)
          : DOAEstimatorSRPEB(nB, sr, fftLen, false, 1, maxOrder, false) {}
      const gsl_vector* acc() const { return accRPs_; }
      const gsl_vector_complex* sv(unsigned u, unsigned fb) { return svTbl_[u][fb]; }
      const gsl_vector_complex* stsnap(unsigned fb) { return st_snapshot_array_->snapshot(fb); }
    };
    class SRPSphDriver : public DOAEstimatorSRPSphDSB {
     public:
      SRPSphDriver(unsigned nB, unsigned sr, unsigned fftLen, unsigned maxOrder)
          : DOAEstimatorSRPSphDSB(nB, sr, fftLen, false, 1, maxOrder, false) {}
      const gsl_vector* acc() const { return accRPs_; }
      const gsl_vector_complex* sv(unsigned u, unsigned fb) { return svTbl_[u][fb]; }
      const gsl_vector_complex* stsnap(unsigned fb) { return st_snapshot_array_->snapshot(fb); }
    };
    typedef Inherit<SRPEBDriver, EigenBeamformerPtr> SRPEBDriverPtr;
    typedef Inherit<SRPSphDriver, SphericalDSBeamformerPtr> SRPSphDriverPtr;

    EigenBeamformerPtr bf;
    DOAEstimatorSRPBase* srp = NULL;
    const gsl_vector* (SRPEBDriver::*accEB)() const = NULL;
    SRPEBDriver* eb = NULL;
    SRPSphDriver* sph = NULL;
    if (kind == "srpeb") {
      eb = new SRPEBDriver(nbest, (unsigned)fs, M, maxorder);
      bf = (EigenBeamformerPtr)(DOAEstimatorSRPEB*)eb;
      srp = eb;
    } else if (kind == "srpsphdsb") {
      sph = new SRPSphDriver(nbest, (unsigned)fs, M, maxorder);
      bf = (EigenBeamformerPtr)(DOAEstimatorSRPSphDSB*)sph;
      srp = sph;
    } else { fprintf(stderr, "unknown srp kind %s\n", kind.c_str()); return 1; }
    (void)accEB;

    std::vector<RawSampleFeaturePtr> sources;
    std::vector<OverSampledDFTAnalysisBankPtr> banks;
    for (; argp < argc; argp++) {
      std::vector<float> x = read_f32(argv[argp]);
      RawSampleFeaturePtr src = new RawSampleFeature(x, D);
      OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
          (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
      bf->set_channel((VectorComplexFeatureStreamPtr&)afb);
      sources.push_back(src);
      banks.push_back(afb);
    }
    bf->set_eigenmike_geometry();
    srp->set_search_param(minT, maxT, minP, maxP, wT, wP);

    for (int fr = 0; nframes == 0 || fr < nframes; fr++) {
      try {
        bf->next();
      } catch (jiterator_error&) {
        break;
      }
    }
    const gsl_vector* acc = (eb != NULL) ? eb->acc() : sph->acc();
    FILE* fp = fopen(outfn, "wb");
    for (unsigned i = 0; i < acc->size; i++) {
      double v = gsl_vector_get(acc, i);
      fwrite(&v, sizeof(double), 1, fp);
    }
    const gsl_vector* nb = srp->nbest_rps();
    for (unsigned i = 0; i < nb->size; i++) {
      double v = gsl_vector_get(nb, i);
      fwrite(&v, sizeof(double), 1, fp);
    }
    const gsl_matrix* doas = srp->nbest_doas();
    for (unsigned i = 0; i < doas->size1; i++)
      for (unsigned j = 0; j < 2; j++) {
        double v = gsl_matrix_get(doas, i, j);
        fwrite(&v, sizeof(double), 1, fp);
      }
    /* debug tail: svTbl[unit 0][bin 5] and the final st-snapshot(5) */
    {
      unsigned dim = maxorder * maxorder;
      const gsl_vector_complex* w5 = (eb != NULL) ? eb->sv(0, 5) : sph->sv(0, 5);
      for (unsigned j = 0; j < dim; j++) {
        gsl_complex z = gsl_vector_complex_get(w5, j);
        fwrite(z.dat, sizeof(double), 2, fp);
      }
      const gsl_vector_complex* f5 = (eb != NULL) ? eb->stsnap(5) : sph->stsnap(5);
      for (unsigned j = 0; j < dim; j++) {
        gsl_complex z = gsl_vector_complex_get(f5, j);
        fwrite(z.dat, sizeof(double), 2, fp);
      }
    }
    fclose(fp);
    return 0;
  }

  if (cmd == "tracker") {
    /* tracker order M m r dc a fs useSubbands sigma2_u sigma2_v \
     *         sigma2_init maxLocalN theta_src phi_src theta0 phi0 \
     *         in.f32 snap_out.c128 track_out.f32
     * Full spherical-tracker loop (tracker.cc): mono source -> analysis ->
     * PlaneWaveSimulator x32 (Eigenmike) -> ModalSphericalArrayTracker.
     * Dumps the simulated 32-channel snapshots [T, 32, M] (so the JAX
     * side tracks from IDENTICAL observations) and the per-frame
     * (theta, phi) track [T, 2]. */
    gsl_vector* h = to_gsl(read_f64(argv[2]));
    unsigned order = atoi(argv[3]);
    unsigned M = atoi(argv[4]), m = atoi(argv[5]), r = atoi(argv[6]), dc = atoi(argv[7]);
    double a = atof(argv[8]), fs = atof(argv[9]);
    unsigned useSub = atoi(argv[10]);
    double s2u = atof(argv[11]), s2v = atof(argv[12]), s2i = atof(argv[13]);
    unsigned maxLocalN = atoi(argv[14]);
    double thetaS = atof(argv[15]), phiS = atof(argv[16]);
    double theta0 = atof(argv[17]), phi0 = atof(argv[18]);
    std::vector<float> x = read_f32(argv[19]);
    unsigned D = M >> r;

    ModalDecompositionPtr modal = new ModalDecomposition(order, M, a, fs, useSub);

    /* pass 1: dump the simulated snapshots */
    {
      RawSampleFeaturePtr src = new RawSampleFeature(x, D);
      OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
          (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
      std::vector<PlaneWaveSimulatorPtr> sims;
      for (unsigned c = 0; c < 32; c++)
        sims.push_back(new PlaneWaveSimulator(
            (VectorComplexFeatureStreamPtr&)afb, modal, c, thetaS, phiS));
      FILE* fp = fopen(argv[20], "wb");
      for (int frame = 0;; frame++) {
        bool done = false;
        for (unsigned c = 0; c < 32; c++) {
          const gsl_vector_complex* Y;
          try {
            Y = sims[c]->next(frame);
          } catch (jiterator_error&) {
            done = true;
            break;
          }
          for (unsigned k = 0; k < M; k++) {
            gsl_complex z = gsl_vector_complex_get(Y, k);
            fwrite(z.dat, sizeof(double), 2, fp);
          }
        }
        if (done) break;
      }
      fclose(fp);
    }

    /* pass 2: fresh graph through the tracker */
    RawSampleFeaturePtr src = new RawSampleFeature(x, D);
    OverSampledDFTAnalysisBankPtr afb = new OverSampledDFTAnalysisBank(
        (VectorFloatFeatureStreamPtr&)src, h, M, m, r, dc);
    ModalSphericalArrayTrackerPtr trk = new ModalSphericalArrayTracker(
        modal, s2u, s2v, s2i, maxLocalN);
    std::vector<PlaneWaveSimulatorPtr> sims2;
    for (unsigned c = 0; c < 32; c++) {
      PlaneWaveSimulatorPtr sim = new PlaneWaveSimulator(
          (VectorComplexFeatureStreamPtr&)afb, modal, c, thetaS, phiS);
      trk->set_channel((VectorComplexFeatureStreamPtr&)sim);
      sims2.push_back(sim);
    }
    trk->set_initial_position(theta0, phi0);
    FILE* fp = fopen(argv[21], "wb");
    for (;;) {
      const gsl_vector_float* pos;
      try {
        pos = trk->next();
      } catch (jiterator_error&) {
        break;
      }
      for (unsigned i = 0; i < 2; i++) {
        float v = gsl_vector_float_get(pos, i);
        fwrite(&v, sizeof(float), 1, fp);
      }
    }
    fclose(fp);
    return 0;
  }

  if (cmd == "tracker_lin") {
    /* tracker_lin order M a fs useSubbands theta phi snap.c128 out.c128
     * One-frame linearization dump: estimate_Bkl over all subbands at
     * (theta, phi) from the given [M/2+1, modesN-transformable] snapshot
     * frame [32, M/2+1 used], then write bkl_[F], dbkl_dtheta[F],
     * dbkl_dphi[F], Hbar_k [obs, 2], yhat_k [obs] in order. */
    unsigned order = atoi(argv[2]);
    unsigned M = atoi(argv[3]);
    double a = atof(argv[4]), fs = atof(argv[5]);
    unsigned useSub = atoi(argv[6]);
    double theta = atof(argv[7]), phi = atof(argv[8]);
    std::vector<double> sn = read_f64(argv[9]);  /* interleaved c128 [32, F] */
    unsigned F = M / 2 + 1;
    /* driver-side subclass exposing the protected Bkl tables */
    class LinProbe : public ModalDecomposition {
     public:
      LinProbe(unsigned o, unsigned M_, double a_, double fs_, unsigned u)
          : ModalDecomposition(o, M_, a_, fs_, u) {}
      gsl_complex get_bkl(unsigned k) { return gsl_vector_complex_get(bkl_, k); }
      gsl_complex get_dbt(unsigned k) { return gsl_vector_complex_get(dbkl_dtheta_, k); }
      gsl_complex get_dbp(unsigned k) { return gsl_vector_complex_get(dbkl_dphi_, k); }
      gsl_complex get_gkl(unsigned k, unsigned j) { return gsl_vector_complex_get(gkl_[k], j); }
      gsl_complex get_dgt(unsigned k, unsigned j) { return gsl_vector_complex_get(dgkl_dtheta_[k], j); }
      gsl_complex get_vkl(unsigned j) { return gsl_vector_complex_get(vkl_, j); }
      gsl_complex get_bn(unsigned k, unsigned n) { return gsl_vector_complex_get(bn_[k], n); }
    };
    typedef Inherit<LinProbe, ModalDecompositionPtr> LinProbePtr;
    LinProbePtr modal = new LinProbe(order, M, a, fs, useSub);
    gsl_vector_complex* snap = gsl_vector_complex_calloc(32);
    gsl_vector* eta = gsl_vector_calloc(2);
    gsl_vector_set(eta, 0, theta);
    gsl_vector_set(eta, 1, phi);
    for (unsigned subbandX = 0; subbandX < F; subbandX++) {
      for (unsigned c = 0; c < 32; c++)
        gsl_vector_complex_set(snap, c,
            gsl_complex_rect(sn[2 * (c * F + subbandX)], sn[2 * (c * F + subbandX) + 1]));
      modal->estimate_Bkl(theta, phi, snap, subbandX);
    }
    const gsl_matrix_complex* H = modal->linearize(eta, 0);
    const gsl_vector_complex* yhat = modal->predicted_observation(eta, 0);
    FILE* fp = fopen(argv[10], "wb");
    for (unsigned k = 0; k < F; k++) {
      gsl_complex z = modal->get_bkl(k);
      fwrite(z.dat, sizeof(double), 2, fp);
    }
    for (unsigned k = 0; k < F; k++) {
      gsl_complex z = modal->get_dbt(k);
      fwrite(z.dat, sizeof(double), 2, fp);
    }
    for (unsigned k = 0; k < F; k++) {
      gsl_complex z = modal->get_dbp(k);
      fwrite(z.dat, sizeof(double), 2, fp);
    }
    unsigned obsN = modal->useSubbandsN() * modal->subbandLengthN();
    for (unsigned i = 0; i < obsN; i++)
      for (unsigned j = 0; j < 2; j++) {
        gsl_complex z = gsl_matrix_complex_get(H, i, j);
        fwrite(z.dat, sizeof(double), 2, fp);
      }
    for (unsigned i = 0; i < obsN; i++) {
      gsl_complex z = gsl_vector_complex_get(yhat, i);
      fwrite(z.dat, sizeof(double), 2, fp);
    }
    /* selected subband order */
    for (BaseDecomposition::Iterator itr(modal->subbandList()); itr.more(); itr++) {
      double sx = (double)(*itr).subbandX();
      fwrite(&sx, sizeof(double), 1, fp);
      fwrite(&sx, sizeof(double), 1, fp);
    }
    /* debug: gkl_/vkl_ for subband 10, bn table for subband 10 */
    {
      unsigned k = 10;
      unsigned modesN = (order + 1) * (order + 1);
      for (unsigned c = 0; c < 32; c++)
        gsl_vector_complex_set(snap, c,
            gsl_complex_rect(sn[2 * (c * F + k)], sn[2 * (c * F + k) + 1]));
      modal->estimate_Bkl(theta, phi, snap, k);
      for (unsigned j = 0; j < modesN; j++) {
        gsl_complex z = modal->get_gkl(k, j);
        fwrite(z.dat, sizeof(double), 2, fp);
      }
      for (unsigned j = 0; j < modesN; j++) {
        gsl_complex z = modal->get_vkl(j);
        fwrite(z.dat, sizeof(double), 2, fp);
      }
      for (unsigned n = 0; n <= order; n++) {
        gsl_complex z = modal->get_bn(k, n);
        fwrite(z.dat, sizeof(double), 2, fp);
      }
      for (unsigned j = 0; j < modesN; j++) {
        gsl_complex z = modal->get_dgt(k, j);
        fwrite(z.dat, sizeof(double), 2, fp);
      }
    }
    fclose(fp);
    return 0;
  }

  if (cmd == "aec2") {
    /* aec2 kind h.f64 g.f64 M m r dc sampleN beta sigmau2 sigmak2 \
     *      x1 x2 x3 x4 play.f32 rec.f32 out.f32
     * Kalman-family AEC tail (aec/aec.h:104-328):
     *   kind=block_kalman: x1=threshold x2=amp4play       (x3 x4 ignored)
     *   kind=info:         x1=snrTh x2=engTh x3=smooth x4=loading
     *   kind=srif:         x1=snrTh x2=engTh x3=smooth x4=loading
     *   kind=dtd:          x1=snrTh x2=engTh x3=smooth x4=amp4play */
    std::string kind = argv[2];
    gsl_vector* h = to_gsl(read_f64(argv[3]));
    gsl_vector* g = to_gsl(read_f64(argv[4]));
    unsigned M = atoi(argv[5]), m = atoi(argv[6]), r = atoi(argv[7]), dc = atoi(argv[8]);
    unsigned sampleN = atoi(argv[9]);
    double beta = atof(argv[10]), sigmau2 = atof(argv[11]), sigmak2 = atof(argv[12]);
    double x1 = atof(argv[13]), x2 = atof(argv[14]), x3 = atof(argv[15]), x4 = atof(argv[16]);
    std::vector<float> vplay = read_f32(argv[17]);
    std::vector<float> vrec = read_f32(argv[18]);
    unsigned D = M >> r;
    RawSampleFeaturePtr psrc = new RawSampleFeature(vplay, D);
    RawSampleFeaturePtr rsrc = new RawSampleFeature(vrec, D);
    OverSampledDFTAnalysisBankPtr pafb = new OverSampledDFTAnalysisBank(
        (VectorFloatFeatureStreamPtr&)psrc, h, M, m, r, dc);
    OverSampledDFTAnalysisBankPtr rafb = new OverSampledDFTAnalysisBank(
        (VectorFloatFeatureStreamPtr&)rsrc, h, M, m, r, dc);
    VectorComplexFeatureStreamPtr pstr = (VectorComplexFeatureStreamPtr&)pafb;
    VectorComplexFeatureStreamPtr rstr = (VectorComplexFeatureStreamPtr&)rafb;
    VectorComplexFeatureStreamPtr aec;
    if (kind == "block_kalman")
      aec = new BlockKalmanFilterEchoCancellationFeature(
          pstr, rstr, sampleN, beta, sigmau2, sigmak2, /*threshold=*/x1,
          /*amp4play=*/x2);
    else if (kind == "info")
      aec = new InformationFilterEchoCancellationFeature(
          pstr, rstr, sampleN, beta, sigmau2, sigmak2, /*snrTh=*/x1,
          /*engTh=*/x2, /*smooth=*/x3, /*loading=*/x4);
    else if (kind == "srif")
      aec = new SquareRootInformationFilterEchoCancellationFeature(
          pstr, rstr, sampleN, beta, sigmau2, sigmak2, /*snrTh=*/x1,
          /*engTh=*/x2, /*smooth=*/x3, /*loading=*/x4);
    else if (kind == "dtd")
      aec = new DTDBlockKalmanFilterEchoCancellationFeature(
          pstr, rstr, sampleN, beta, sigmau2, sigmak2, /*snrTh=*/x1,
          /*engTh=*/x2, /*smooth=*/x3, /*amp4play=*/x4);
    else {
      fprintf(stderr, "unknown aec2 kind %s\n", kind.c_str());
      return 1;
    }
    OverSampledDFTSynthesisBankPtr sfb =
        new OverSampledDFTSynthesisBank(aec, g, M, m, r, dc);
    drain_to_f32((VectorFloatFeatureStreamPtr&)sfb, D, argv[19]);
    return 0;
  }

  fprintf(stderr, "unknown subcommand %s\n", cmd.c_str());
  return 1;
}
