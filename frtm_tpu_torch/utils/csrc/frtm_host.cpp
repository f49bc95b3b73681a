// frtm_host: the PyTorch port's host library, built with the host compiler at
// first use (frtm_tpu_torch/utils/native.py) and bound with ctypes, which
// releases the interpreter lock for the length of every call.
//
// The counterpart of native/frtm_native.cpp (the JAX package's host library)
// plus the two OpenCV calls that the JAX augmenter makes on the host
// (cv2.dilate with the 2x2 ellipse, cv2.inpaint with INPAINT_TELEA). It holds:
//
//   * dilate_ellipse2_u8, inpaint_telea_u8c3: the algorithm of
//     frtm_tpu_torch/models/inpaint.py step by step, bit-equal to it: OpenCV's
//     narrow band as a heap keyed by (time, arrival number), so that equal
//     times leave in arrival order; the outward march over the ring, then the
//     inward fill. Arithmetic is float where OpenCV's is float and double
//     where it is double (the arrival-time solve, the distance weight and
//     1 / (1 + fabs(dt)), each rounded to float once). Built with
//     -ffp-contract=off and without -ffast-math: a contracted a*b+c (an FMA)
//     rounds once where the plain version rounds twice.
//   * png_samples: undoes the five PNG row filters (data/image.py inflates
//     with zlib and hands the raw rows here), unpacks 1-, 2-, 4- and 16-bit
//     samples and puts the seven passes of an Adam7-interlaced image in
//     their places.
//   * jpeg_dims, decode_jpeg, batch_decode_jpeg_files: JPEG to (H, W, 3)
//     uint8 RGB on the host. The decoder is chosen when the library is built:
//     libjpeg where jpeglib.h compiles (FRTM_HOST_LIBJPEG), else nvJPEG from
//     the CUDA toolkit (FRTM_HOST_NVJPEG). nvJPEG decodes to the image's own
//     Y, Cb and Cr planes on the card; they are copied to the host, and the
//     chroma is upsampled and converted to RGB there as libjpeg does it
//     (ycc_planes_to_rgb: "fancy" triangle upsampling, libjpeg's fixed-point
//     colour tables), so that both backends give the same pixels where their
//     IDCTs agree. The batch call decodes same-size files on a pool of
//     threads.
//   * resize_u8: cv2.resize of uint8 images for the training loaders,
//     nearest, area (OpenCV's three INTER_AREA paths) and cubic, the arithmetic of
//     frtm_tpu_torch/data/resize_host.py's plain versions step by step and
//     equal to them on every value (float where they are float32, double
//     where they are double, no contraction).
//
// Every entry point has a plain C interface and returns 0 on success.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#if defined(FRTM_HOST_LIBJPEG)
#include <csetjmp>
#include <jpeglib.h>
#elif defined(FRTM_HOST_NVJPEG)
#include <cuda_runtime_api.h>
#include <mutex>
#include <nvjpeg.h>
#else
#error "define FRTM_HOST_LIBJPEG or FRTM_HOST_NVJPEG"
#endif

#define FRTM_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

// ---------------------------------------------------------------------------
// Morphology

// Max over a (2r+1)^2 square, or over the radius-1 cross, zero outside.
void dilate(const uint8_t* img, int h, int w, int r, bool cross, uint8_t* out) {
    std::memcpy(out, img, static_cast<size_t>(h) * w);
    for (int dy = -r; dy <= r; ++dy) {
        for (int dx = -r; dx <= r; ++dx) {
            if (cross && dy && dx) continue;
            for (int y = std::max(0, -dy); y < std::min(h, h - dy); ++y) {
                const uint8_t* src = img + static_cast<size_t>(y + dy) * w;
                uint8_t* dst = out + static_cast<size_t>(y) * w;
                for (int x = std::max(0, -dx); x < std::min(w, w - dx); ++x)
                    dst[x] = std::max(dst[x], src[x + dx]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Telea inpainting (models/inpaint.py; OpenCV photo/src/inpaint.cpp)

enum : uint8_t { KNOWN = 0, BAND = 1, INSIDE = 2, CHANGE = 3 };

struct BandEntry {
    float t;
    int64_t n;  // arrival number: equal times leave in arrival order
    int i, j;
};

struct Later {
    bool operator()(const BandEntry& a, const BandEntry& b) const {
        return a.t > b.t || (a.t == b.t && a.n > b.n);
    }
};

using Band = std::priority_queue<BandEntry, std::vector<BandEntry>, Later>;

struct Grid {
    int rows, cols;  // (H + 2, W + 2): a one-pixel border around the image
    std::vector<uint8_t> f;
    std::vector<float> t;
    uint8_t& F(int i, int j) { return f[static_cast<size_t>(i) * cols + j]; }
    float& T(int i, int j) { return t[static_cast<size_t>(i) * cols + j]; }
};

// OpenCV's FastMarching_solve, in double, returned as float. `f` holds the
// flags the solve reads (the ring in the outward march).
float solve(const uint8_t* f, const float* t, int cols, int i1, int j1, int i2, int j2) {
    const size_t p1 = static_cast<size_t>(i1) * cols + j1;
    const size_t p2 = static_cast<size_t>(i2) * cols + j2;
    const double a11 = t[p1];
    const double a22 = t[p2];
    const double m12 = std::min(a11, a22);
    double sol;
    if (f[p1] != INSIDE) {
        if (f[p2] != INSIDE) {
            if (std::fabs(a11 - a22) >= 1.0) {
                sol = 1.0 + m12;
            } else {
                const double d = a11 - a22;
                sol = (a11 + a22 + std::sqrt(2.0 - d * d)) * 0.5;
            }
        } else {
            sol = 1.0 + a11;
        }
    } else if (f[p2] != INSIDE) {
        sol = 1.0 + a22;
    } else {
        sol = 1.0 + m12;
    }
    return static_cast<float>(sol);
}

float arrival(const uint8_t* f, const float* t, int cols, int i, int j) {
    float m = solve(f, t, cols, i - 1, j, i, j - 1);
    m = std::min(m, solve(f, t, cols, i + 1, j, i, j - 1));
    m = std::min(m, solve(f, t, cols, i - 1, j, i, j + 1));
    m = std::min(m, solve(f, t, cols, i + 1, j, i, j + 1));
    return m;
}

const int NEIGHBOURS[4][2] = {{-1, 0}, {0, -1}, {1, 0}, {0, 1}};

// icvCalcFMM with negate=true over the ring (INSIDE = to do): the known
// side gets negative arrival times.
void march_outward(std::vector<uint8_t>& ring, std::vector<float>& t, int rows, int cols,
                   const std::vector<std::pair<int, int>>& seeds) {
    Band band;
    int64_t count = 0;
    for (const auto& s : seeds) band.push({0.0f, count++, s.first, s.second});
    uint8_t* f = ring.data();
    while (!band.empty()) {
        const BandEntry e = band.top();
        band.pop();
        f[static_cast<size_t>(e.i) * cols + e.j] = CHANGE;
        for (const auto& d : NEIGHBOURS) {
            const int i = e.i + d[0], j = e.j + d[1];
            if (i <= 0 || j <= 0 || i > rows || j > cols) continue;
            const size_t p = static_cast<size_t>(i) * cols + j;
            if (f[p] == INSIDE) {
                const float dist = arrival(f, t.data(), cols, i, j);
                t[p] = dist;
                f[p] = BAND;
                band.push({dist, count++, i, j});
            }
        }
    }
    for (size_t p = 0; p < ring.size(); ++p) {
        if (f[p] == CHANGE) {
            f[p] = KNOWN;
            t[p] = -t[p];
        }
    }
}

// Telea's weighted estimate of hole pixel (i, j) (bordered coordinates),
// written to `out` (H, W, 3) in place.
void fill(Grid& g, uint8_t* out, int W, int i, int j, int radius, float gx, float gy) {
    const int rows = g.rows, cols = g.cols;
    const float tij = g.T(i, j);
    auto px = [&](int y, int x, int c) -> int {
        return out[(static_cast<size_t>(y) * W + x) * 3 + c];
    };
    for (int color = 0; color < 3; ++color) {
        float Ia = 0.0f, Jx = 0.0f, Jy = 0.0f, s = 1.0e-20f;
        for (int k = i - radius; k <= i + radius; ++k) {
            const int km = k - 1 + (k == 1);
            const int kp = k - 1 - (k == rows - 2);
            for (int l = j - radius; l <= j + radius; ++l) {
                if (!(0 < k && k < rows - 1 && 0 < l && l < cols - 1)) continue;
                if (g.F(k, l) == INSIDE ||
                    (l - j) * (l - j) + (k - i) * (k - i) > radius * radius)
                    continue;
                const int lm = l - 1 + (l == 1);
                const int lp = l - 1 - (l == cols - 2);
                const float ry = static_cast<float>(i - k);
                const float rx = static_cast<float>(j - l);
                const float length = rx * rx + ry * ry;
                const double ld = length;
                const float dst = static_cast<float>(1.0 / (ld * std::sqrt(ld)));
                const float dt = g.T(k, l) - tij;
                const float lev = static_cast<float>(1.0 / (1.0 + std::fabs(static_cast<double>(dt))));
                float direction = rx * gx + ry * gy;
                if (std::fabs(static_cast<double>(direction)) <= 0.01) direction = 0.000001f;
                const float wgt = std::fabs(dst * lev * direction);
                float gix, giy;
                if (g.F(k, l + 1) != INSIDE) {
                    if (g.F(k, l - 1) != INSIDE)
                        gix = static_cast<float>(px(km, lp + 1, color) - px(km, lm - 1, color)) * 2.0f;
                    else
                        gix = static_cast<float>(px(km, lp + 1, color) - px(km, lm, color));
                } else {
                    if (g.F(k, l - 1) != INSIDE)
                        gix = static_cast<float>(px(km, lp, color) - px(km, lm - 1, color));
                    else
                        gix = 0.0f;
                }
                if (g.F(k + 1, l) != INSIDE) {
                    if (g.F(k - 1, l) != INSIDE)
                        giy = static_cast<float>(px(kp + 1, lm, color) - px(km - 1, lm, color)) * 2.0f;
                    else
                        giy = static_cast<float>(px(kp + 1, lm, color) - px(km, lm, color));
                } else {
                    if (g.F(k - 1, l) != INSIDE)
                        giy = static_cast<float>(px(kp, lm, color) - px(km - 1, lm, color));
                    else
                        giy = 0.0f;
                }
                Ia = Ia + wgt * static_cast<float>(px(k - 1, l - 1, color));
                Jx = Jx - wgt * (gix * rx);
                Jy = Jy - wgt * (giy * ry);
                s = s + wgt;
            }
        }
        const float sat = Ia / s + (Jx + Jy) / (std::sqrt(Jx * Jx + Jy * Jy) + 1.0e-20f) + 0.5f;
        const float r = std::nearbyint(sat);  // round half to even, as np.rint
        int v = static_cast<int>(std::max(-1.0f, std::min(256.0f, r)));
        out[(static_cast<size_t>(i - 1) * W + (j - 1)) * 3 + color] =
            static_cast<uint8_t>(std::min(std::max(v, 0), 255));
    }
}

// gradT of OpenCV's Telea step, one-sided where a side is INSIDE.
void grad_t(Grid& g, int i, int j, float* gx, float* gy) {
    if (g.F(i, j + 1) != INSIDE) {
        *gx = g.F(i, j - 1) != INSIDE ? (g.T(i, j + 1) - g.T(i, j - 1)) * 0.5f
                                      : g.T(i, j + 1) - g.T(i, j);
    } else {
        *gx = g.F(i, j - 1) != INSIDE ? g.T(i, j) - g.T(i, j - 1) : 0.0f;
    }
    if (g.F(i + 1, j) != INSIDE) {
        *gy = g.F(i - 1, j) != INSIDE ? (g.T(i + 1, j) - g.T(i - 1, j)) * 0.5f
                                      : g.T(i + 1, j) - g.T(i, j);
    } else {
        *gy = g.F(i - 1, j) != INSIDE ? g.T(i, j) - g.T(i - 1, j) : 0.0f;
    }
}

// ---------------------------------------------------------------------------
// PNG row filters

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    return static_cast<uint8_t>(pb <= pc ? b : c);
}

// Undo the per-row filters of one image (or one Adam7 pass): raw holds
// height rows of (1 filter byte + stride bytes); out gets (height, stride).
// Returns -1, or the first row whose filter type is unknown.
int unfilter_rows(const uint8_t* raw, int height, int64_t stride, int bpp, uint8_t* out) {
    std::vector<uint8_t> zeros(stride, 0);
    for (int y = 0; y < height; ++y) {
        const uint8_t* line = raw + static_cast<size_t>(y) * (stride + 1);
        const uint8_t ftype = line[0];
        ++line;
        const uint8_t* prev = y ? out + static_cast<size_t>(y - 1) * stride : zeros.data();
        uint8_t* cur = out + static_cast<size_t>(y) * stride;
        switch (ftype) {
            case 0:
                std::memcpy(cur, line, stride);
                break;
            case 1:  // Sub
                for (int64_t i = 0; i < stride; ++i)
                    cur[i] = static_cast<uint8_t>(line[i] + (i >= bpp ? cur[i - bpp] : 0));
                break;
            case 2:  // Up
                for (int64_t i = 0; i < stride; ++i) cur[i] = static_cast<uint8_t>(line[i] + prev[i]);
                break;
            case 3:  // Average
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    cur[i] = static_cast<uint8_t>(line[i] + ((a + prev[i]) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    const int c = i >= bpp ? prev[i - bpp] : 0;
                    cur[i] = static_cast<uint8_t>(line[i] + paeth(a, prev[i], c));
                }
                break;
            default:
                return y;
        }
    }
    return -1;
}

// Adam7: first column, first row, column step, row step of each pass.
constexpr int ADAM7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                             {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

struct PngPass {
    int x0, y0, dx, dy, rows, cols;
};

// The sub-images a PNG's image data holds, in order: the whole image, or the
// non-empty Adam7 passes.
std::vector<PngPass> png_passes(int h, int w, bool interlace) {
    std::vector<PngPass> out;
    for (int p = 0; p < (interlace ? 7 : 1); ++p) {
        const int* a = interlace ? ADAM7[p] : nullptr;
        PngPass q{a ? a[0] : 0, a ? a[1] : 0, a ? a[2] : 1, a ? a[3] : 1, 0, 0};
        q.rows = (h - q.y0 + q.dy - 1) / q.dy;
        q.cols = (w - q.x0 + q.dx - 1) / q.dx;
        if (q.rows > 0 && q.cols > 0) out.push_back(q);
    }
    return out;
}

// Sample i of an unfiltered row: a sub-byte sample's raw value (most
// significant bits first), a byte, or a big-endian 16-bit word.
inline unsigned sample(const uint8_t* row, long i, int depth) {
    if (depth == 8) return row[i];
    if (depth == 16) return (static_cast<unsigned>(row[2 * i]) << 8) | row[2 * i + 1];
    const long bit = i * depth;
    return (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1u << depth) - 1);
}

void set_error(char* err, int errlen, const std::string& msg) {
    if (err && errlen > 0) {
        std::strncpy(err, msg.c_str(), errlen - 1);
        err[errlen - 1] = '\0';
    }
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    const long len = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    buf->resize(len > 0 ? len : 0);
    const bool ok = len > 0 && std::fread(buf->data(), 1, len, f) == static_cast<size_t>(len);
    std::fclose(f);
    return ok;
}

// ---------------------------------------------------------------------------
// JPEG

// libjpeg's (and libjpeg-turbo's) chroma upsampling with do_fancy_upsampling
// (jdsample.c: h2v1 and h2v2 "fancy", a triangle filter with its rounding
// biases; the row above the first and the row below the last are those
// rows again) and its YCbCr -> RGB conversion (jdcolor.c: 16-bit
// fixed-point tables). Planes: luma (H x W, stride ys), chroma (ch x cw,
// stride cs) at 1/hfac x 1/vfac of the luma; cb == nullptr for a greyscale
// image, whose RGB is the luma three times. Returns -1 for a sampling it
// does not take.
int ycc_planes_to_rgb(const uint8_t* y, size_t ys, const uint8_t* cb, const uint8_t* cr,
                      size_t cs, int cw, int ch, int hfac, int vfac, int H, int W,
                      uint8_t* out) {
    if (!cb) {
        for (int r = 0; r < H; ++r)
            for (int x = 0; x < W; ++x) {
                uint8_t* o = out + (static_cast<size_t>(r) * W + x) * 3;
                o[0] = o[1] = o[2] = y[r * ys + x];
            }
        return 0;
    }
    if (hfac < 1 || hfac > 2 || vfac < 1 || vfac > 2 || (vfac == 2 && hfac != 2) ||
        (hfac == 2 && cw < 2) || cw * hfac < W || ch * vfac < H)
        return -1;
    // the chroma planes at full resolution, cw * hfac wide
    const int uw = cw * hfac;
    std::vector<uint8_t> up[2] = {std::vector<uint8_t>(static_cast<size_t>(uw) * H),
                                  std::vector<uint8_t>(static_cast<size_t>(uw) * H)};
    const uint8_t* planes[2] = {cb, cr};
    for (int c = 0; c < 2; ++c) {
        for (int r = 0; r < H; ++r) {
            const int inrow = r / vfac;
            const uint8_t* in0 = planes[c] + inrow * cs;
            uint8_t* o = up[c].data() + static_cast<size_t>(r) * uw;
            if (hfac == 1) {
                std::memcpy(o, in0, cw);
            } else if (vfac == 1) {  // h2v1_fancy_upsample
                int v = in0[0];
                *o++ = static_cast<uint8_t>(v);
                *o++ = static_cast<uint8_t>((v * 3 + in0[1] + 2) >> 2);
                for (int col = 1; col < cw - 1; ++col) {
                    v = in0[col] * 3;
                    *o++ = static_cast<uint8_t>((v + in0[col - 1] + 1) >> 2);
                    *o++ = static_cast<uint8_t>((v + in0[col + 1] + 2) >> 2);
                }
                v = in0[cw - 1];
                *o++ = static_cast<uint8_t>((v * 3 + in0[cw - 2] + 1) >> 2);
                *o++ = static_cast<uint8_t>(v);
            } else {  // h2v2_fancy_upsample: the nearer row 3/4, the other 1/4
                const int other = r % 2 == 0 ? std::max(inrow - 1, 0) : std::min(inrow + 1, ch - 1);
                const uint8_t* in1 = planes[c] + other * cs;
                int thiscolsum = in0[0] * 3 + in1[0];
                int nextcolsum = in0[1] * 3 + in1[1];
                *o++ = static_cast<uint8_t>((thiscolsum * 4 + 8) >> 4);
                *o++ = static_cast<uint8_t>((thiscolsum * 3 + nextcolsum + 7) >> 4);
                int lastcolsum = thiscolsum;
                thiscolsum = nextcolsum;
                for (int col = 2; col < cw; ++col) {
                    nextcolsum = in0[col] * 3 + in1[col];
                    *o++ = static_cast<uint8_t>((thiscolsum * 3 + lastcolsum + 8) >> 4);
                    *o++ = static_cast<uint8_t>((thiscolsum * 3 + nextcolsum + 7) >> 4);
                    lastcolsum = thiscolsum;
                    thiscolsum = nextcolsum;
                }
                *o++ = static_cast<uint8_t>((thiscolsum * 3 + lastcolsum + 8) >> 4);
                *o++ = static_cast<uint8_t>((thiscolsum * 4 + 7) >> 4);
            }
        }
    }
    // jdcolor.c's tables: SCALEBITS 16, FIX(x) = x * 2^16 rounded
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
        const int64_t x = i - 128;
        cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
        cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
        cr_g[i] = -fix(0.71414) * x;
        cb_g[i] = -fix(0.34414) * x + one_half;
    }
    auto limit = [](int v) { return static_cast<uint8_t>(std::min(std::max(v, 0), 255)); };
    for (int r = 0; r < H; ++r) {
        const uint8_t* yr = y + r * ys;
        const uint8_t* br = up[0].data() + static_cast<size_t>(r) * uw;
        const uint8_t* rr = up[1].data() + static_cast<size_t>(r) * uw;
        uint8_t* o = out + static_cast<size_t>(r) * W * 3;
        for (int x = 0; x < W; ++x, o += 3) {
            const int yy = yr[x], b = br[x], rd = rr[x];
            o[0] = limit(yy + cr_r[rd]);
            o[1] = limit(yy + static_cast<int>((cb_g[b] + cr_g[rd]) >> 16));
            o[2] = limit(yy + cb_b[b]);
        }
    }
    return 0;
}

#if defined(FRTM_HOST_LIBJPEG)

#define FRTM_STR2(x) #x
#define FRTM_STR(x) FRTM_STR2(x)
#ifdef LIBJPEG_TURBO_VERSION
const char* BACKEND = "libjpeg-turbo " FRTM_STR(LIBJPEG_TURBO_VERSION);
#else
const char* BACKEND = "libjpeg " FRTM_STR(JPEG_LIB_VERSION);
#endif

struct JErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
    char msg[JMSG_LENGTH_MAX];
};

void jerr_exit(j_common_ptr cinfo) {
    JErr* e = reinterpret_cast<JErr*>(cinfo->err);
    (*cinfo->err->format_message)(cinfo, e->msg);
    std::longjmp(e->jb, 1);
}

// Warnings (a truncated file, corrupt data that libjpeg would decode
// around) are errors here: a frame is decoded whole or not at all.
void jerr_emit(j_common_ptr cinfo, int level) {
    if (level < 0) jerr_exit(cinfo);
}

// mode 0: header only (dims); mode 1: decode into out (h x w x 3)
int jpeg_run(const uint8_t* buf, long len, int* h, int* w, uint8_t* out, int mode,
             char* err, int errlen) {
    jpeg_decompress_struct cinfo;
    JErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jerr_exit;
    jerr.mgr.emit_message = jerr_emit;
    jerr.msg[0] = '\0';
    if (setjmp(jerr.jb)) {
        set_error(err, errlen, jerr.msg);
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    if (mode == 0) {
        *h = cinfo.image_height;
        *w = cinfo.image_width;
        jpeg_destroy_decompress(&cinfo);
        return 0;
    }
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    if (static_cast<int>(cinfo.output_height) != *h || static_cast<int>(cinfo.output_width) != *w ||
        cinfo.output_components != 3) {
        set_error(err, errlen, "decoded size " + std::to_string(cinfo.output_height) + "x" +
                                   std::to_string(cinfo.output_width) + "x" +
                                   std::to_string(cinfo.output_components) + ", expected " +
                                   std::to_string(*h) + "x" + std::to_string(*w) + "x3");
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * (*w) * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

struct Decoder {
    int decode(const uint8_t* buf, long len, uint8_t* out, int h, int w, char* err, int errlen) {
        return jpeg_run(buf, len, &h, &w, out, 1, err, errlen);
    }
};

int dims(const uint8_t* buf, long len, int* h, int* w, char* err, int errlen) {
    return jpeg_run(buf, len, h, w, nullptr, 0, err, errlen);
}

// libjpeg's component planes (raw_data_out) through ycc_planes_to_rgb: the
// conversion the nvJPEG build applies to nvJPEG's planes, which the tests
// hold here against libjpeg's own RGB output.
int jpeg_planar(const uint8_t* buf, long len, uint8_t* out, int h, int w, char* err,
                int errlen) {
    jpeg_decompress_struct cinfo;
    JErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jerr_exit;
    jerr.mgr.emit_message = jerr_emit;
    jerr.msg[0] = '\0';
    std::vector<std::vector<uint8_t>> planes;
    std::vector<std::vector<JSAMPROW>> rows;
    if (setjmp(jerr.jb)) {
        set_error(err, errlen, jerr.msg);
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    const int nc = cinfo.num_components;
    if ((nc != 1 && nc != 3) || static_cast<int>(cinfo.image_height) != h ||
        static_cast<int>(cinfo.image_width) != w) {
        set_error(err, errlen, "not a YCbCr or greyscale image of the given size");
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    cinfo.raw_data_out = TRUE;
    jpeg_start_decompress(&cinfo);
    const int mv = cinfo.max_v_samp_factor;
    std::vector<size_t> stride(nc);
    for (int c = 0; c < nc; ++c) {
        const jpeg_component_info& ci = cinfo.comp_info[c];
        stride[c] = static_cast<size_t>(ci.width_in_blocks) * DCTSIZE;
        const size_t nrows = static_cast<size_t>(ci.height_in_blocks + ci.v_samp_factor) * DCTSIZE;
        planes.emplace_back(stride[c] * nrows);
        rows.emplace_back(nrows);
        for (size_t r = 0; r < nrows; ++r) rows[c][r] = planes[c].data() + r * stride[c];
    }
    for (JDIMENSION done = 0; cinfo.output_scanline < cinfo.output_height;
         done += mv * DCTSIZE) {
        JSAMPARRAY arrays[3];
        for (int c = 0; c < nc; ++c)
            arrays[c] = rows[c].data() + done / mv * cinfo.comp_info[c].v_samp_factor;
        jpeg_read_raw_data(&cinfo, arrays, mv * DCTSIZE);
    }
    int rc;
    if (nc == 1) {
        rc = ycc_planes_to_rgb(planes[0].data(), stride[0], nullptr, nullptr, 0, 0, 0, 1, 1, h,
                               w, out);
    } else {
        const jpeg_component_info& c0 = cinfo.comp_info[0];
        const jpeg_component_info& c1 = cinfo.comp_info[1];
        rc = ycc_planes_to_rgb(planes[0].data(), stride[0], planes[1].data(), planes[2].data(),
                               stride[1], c1.downsampled_width, c1.downsampled_height,
                               c0.h_samp_factor / c1.h_samp_factor,
                               c0.v_samp_factor / c1.v_samp_factor, h, w, out);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    if (rc != 0) set_error(err, errlen, "a chroma sampling the planar conversion does not take");
    return rc;
}

#else  // FRTM_HOST_NVJPEG

#define FRTM_STR2(x) #x
#define FRTM_STR(x) FRTM_STR2(x)
const char* BACKEND = "nvjpeg " FRTM_STR(NVJPEG_VER_MAJOR) "." FRTM_STR(NVJPEG_VER_MINOR);

nvjpegHandle_t g_handle = nullptr;
nvjpegStatus_t g_status = NVJPEG_STATUS_SUCCESS;
std::once_flag g_once;

bool handle(char* err, int errlen) {
    std::call_once(g_once, [] { g_status = nvjpegCreateSimple(&g_handle); });
    if (g_status != NVJPEG_STATUS_SUCCESS) {
        set_error(err, errlen, "nvjpegCreateSimple failed: status " + std::to_string(g_status));
        return false;
    }
    return true;
}

int dims(const uint8_t* buf, long len, int* h, int* w, char* err, int errlen) {
    if (!handle(err, errlen)) return -1;
    int n_comp = 0;
    nvjpegChromaSubsampling_t subs;
    int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
    const nvjpegStatus_t st = nvjpegGetImageInfo(g_handle, buf, static_cast<size_t>(len), &n_comp,
                                                 &subs, widths, heights);
    if (st != NVJPEG_STATUS_SUCCESS) {
        set_error(err, errlen, "nvjpegGetImageInfo failed: status " + std::to_string(st));
        return -1;
    }
    *h = heights[0];
    *w = widths[0];
    return 0;
}

// One decoder per thread: its own state, stream and buffers. Where the
// sampling allows, it decodes to the image's planes and converts them on the
// host as libjpeg does (ycc_planes_to_rgb).
struct Decoder {
    nvjpegJpegState_t state = nullptr;
    cudaStream_t stream = nullptr;
    uint8_t* dev = nullptr;
    size_t cap = 0;
    std::vector<uint8_t> host;

    ~Decoder() {
        if (dev) cudaFree(dev);
        if (stream) cudaStreamDestroy(stream);
        if (state) nvjpegJpegStateDestroy(state);
    }

    int decode(const uint8_t* buf, long len, uint8_t* out, int h, int w, char* err, int errlen) {
        if (!handle(err, errlen)) return -1;
        int n_comp = 0;
        nvjpegChromaSubsampling_t subs;
        int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
        nvjpegStatus_t st = nvjpegGetImageInfo(g_handle, buf, static_cast<size_t>(len), &n_comp,
                                               &subs, widths, heights);
        if (st != NVJPEG_STATUS_SUCCESS) {
            set_error(err, errlen, "nvjpegGetImageInfo failed: status " + std::to_string(st));
            return -1;
        }
        if (heights[0] != h || widths[0] != w) {
            set_error(err, errlen, "decoded size " + std::to_string(heights[0]) + "x" +
                                       std::to_string(widths[0]) + ", expected " +
                                       std::to_string(h) + "x" + std::to_string(w));
            return -2;
        }
        // the planes libjpeg's conversion takes: Y alone, or Y, Cb, Cr with
        // chroma at 1x1, 2x1 or 2x2; any other sampling decodes to RGB on the
        // card (nvJPEG's own upsampling and colour conversion)
        int hfac = 0, vfac = 0;
        if (subs == NVJPEG_CSS_GRAY) hfac = vfac = 1;
        if (n_comp == 3 && subs == NVJPEG_CSS_444) hfac = vfac = 1;
        if (n_comp == 3 && subs == NVJPEG_CSS_422) hfac = 2, vfac = 1;
        if (n_comp == 3 && subs == NVJPEG_CSS_420) hfac = vfac = 2;
        const bool planar = hfac && (subs == NVJPEG_CSS_GRAY ||
                                     (widths[1] >= 2 && widths[1] == widths[2] &&
                                      heights[1] == heights[2]));
        const int np = !planar ? 1 : subs == NVJPEG_CSS_GRAY ? 1 : 3;
        size_t offs[3] = {0, 0, 0}, need = 0;
        unsigned int pitch[3] = {0, 0, 0};
        for (int c = 0; c < np; ++c) {
            pitch[c] = static_cast<unsigned int>(planar ? widths[c] : w * 3);
            offs[c] = need;
            need += static_cast<size_t>(pitch[c]) * (planar ? heights[c] : h);
        }
        if (!state) {
            st = nvjpegJpegStateCreate(g_handle, &state);
            if (st != NVJPEG_STATUS_SUCCESS) {
                set_error(err, errlen, "nvjpegJpegStateCreate failed: status " + std::to_string(st));
                return -3;
            }
            if (cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) != cudaSuccess) {
                set_error(err, errlen, "cudaStreamCreate failed");
                return -3;
            }
        }
        if (need > cap) {
            if (dev) cudaFree(dev);
            dev = nullptr;
            cap = 0;
            const cudaError_t ce = cudaMalloc(reinterpret_cast<void**>(&dev), need);
            if (ce != cudaSuccess) {
                set_error(err, errlen, std::string("cudaMalloc failed: ") + cudaGetErrorString(ce));
                return -3;
            }
            cap = need;
        }
        nvjpegImage_t img;
        std::memset(&img, 0, sizeof(img));
        for (int c = 0; c < np; ++c) {
            img.channel[c] = dev + offs[c];
            img.pitch[c] = pitch[c];
        }
        const nvjpegOutputFormat_t format = !planar ? NVJPEG_OUTPUT_RGBI
                                            : subs == NVJPEG_CSS_GRAY ? NVJPEG_OUTPUT_Y
                                                                      : NVJPEG_OUTPUT_YUV;
        st = nvjpegDecode(g_handle, state, buf, static_cast<size_t>(len), format, &img, stream);
        if (st != NVJPEG_STATUS_SUCCESS) {
            set_error(err, errlen, "nvjpegDecode failed: status " + std::to_string(st));
            return -1;
        }
        host.resize(need);
        uint8_t* dst = planar ? host.data() : out;
        cudaError_t ce = cudaMemcpyAsync(dst, dev, need, cudaMemcpyDeviceToHost, stream);
        if (ce == cudaSuccess) ce = cudaStreamSynchronize(stream);
        if (ce != cudaSuccess) {
            set_error(err, errlen, std::string("copy to the host failed: ") + cudaGetErrorString(ce));
            return -3;
        }
        if (!planar) return 0;
        const uint8_t* p = host.data();
        if (np == 1)
            return ycc_planes_to_rgb(p, pitch[0], nullptr, nullptr, 0, 0, 0, 1, 1, h, w, out);
        return ycc_planes_to_rgb(p, pitch[0], p + offs[1], p + offs[2], pitch[1], widths[1],
                                 heights[1], hfac, vfac, h, w, out);
    }
};

#endif

// ---------------------------------------------------------------------------
// Resizing (cv2.resize on uint8, (H, W, C) interleaved)

struct AreaEntry {
    int d, s;
    float w;
};

// OpenCV's computeResizeAreaTab, in its order.
std::vector<AreaEntry> area_table(int ssize, int dsize, double scale) {
    std::vector<AreaEntry> tab;
    for (int dx = 0; dx < dsize; ++dx) {
        const double fsx1 = dx * scale;
        const double fsx2 = fsx1 + scale;
        const double cell = std::min(scale, ssize - fsx1);
        int sx1 = static_cast<int>(std::ceil(fsx1)), sx2 = static_cast<int>(std::floor(fsx2));
        sx2 = std::min(sx2, ssize - 1);
        sx1 = std::min(sx1, sx2);
        if (sx1 - fsx1 > 1e-3) tab.push_back({dx, sx1 - 1, static_cast<float>((sx1 - fsx1) / cell)});
        for (int sx = sx1; sx < sx2; ++sx) tab.push_back({dx, sx, static_cast<float>(1.0 / cell)});
        if (fsx2 - sx2 > 1e-3)
            tab.push_back({dx, sx2, static_cast<float>(std::min(std::min(fsx2 - sx2, 1.), cell) / cell)});
    }
    return tab;
}

inline uint8_t round_u8(float v) {
    const float r = std::nearbyint(v);   // half to even
    return static_cast<uint8_t>(r < 0.f ? 0.f : (r > 255.f ? 255.f : r));
}

// INTER_AREA's general path: both axes shrink, by factors not both whole.
void resize_area_general(const uint8_t* src, int H, int W, int C, int dh, int dw, double sy,
                         double sx, uint8_t* dst) {
    const std::vector<AreaEntry> xt = area_table(W, dw, sx);
    const std::vector<AreaEntry> yt = area_table(H, dh, sy);
    std::vector<float> buf(static_cast<size_t>(dw) * C), acc(static_cast<size_t>(dw) * C);
    size_t j = 0;
    for (int dy = 0; dy < dh; ++dy) {
        std::fill(acc.begin(), acc.end(), 0.f);
        for (; j < yt.size() && yt[j].d == dy; ++j) {
            const uint8_t* row = src + static_cast<size_t>(yt[j].s) * W * C;
            std::fill(buf.begin(), buf.end(), 0.f);
            for (const AreaEntry& e : xt)
                for (int c = 0; c < C; ++c)
                    buf[e.d * C + c] = buf[e.d * C + c] + static_cast<float>(row[e.s * C + c]) * e.w;
            const float beta = yt[j].w;
            for (size_t i = 0; i < acc.size(); ++i) acc[i] = acc[i] + beta * buf[i];
        }
        uint8_t* out = dst + static_cast<size_t>(dy) * dw * C;
        for (size_t i = 0; i < acc.size(); ++i) out[i] = round_u8(acc[i]);
    }
}

// OpenCV's resizeAreaFast: whole factors iy, ix. The integer sum of each
// cell times the float 1 / area, rounded half to even; at 2x2 with 1, 3 or
// 4 channels (sum + 2) >> 2.
void resize_area_fast(const uint8_t* src, int W, int C, int dh, int dw, int iy, int ix,
                      uint8_t* dst) {
    const bool pairs = iy == 2 && ix == 2 && (C == 1 || C == 3 || C == 4);
    const float scale = 1.f / static_cast<float>(iy * ix);
    for (int dy = 0; dy < dh; ++dy)
        for (int dx = 0; dx < dw; ++dx)
            for (int c = 0; c < C; ++c) {
                int sum = 0;
                for (int i = 0; i < iy; ++i) {
                    const uint8_t* row = src + (static_cast<size_t>(dy) * iy + i) * W * C;
                    for (int j = 0; j < ix; ++j) sum += row[(dx * ix + j) * C + c];
                }
                dst[(static_cast<size_t>(dy) * dw + dx) * C + c] =
                    pairs ? static_cast<uint8_t>((sum + 2) >> 2)
                          : round_u8(static_cast<float>(sum) * scale);
            }
}

// OpenCV's area-mode linear table of an axis: per destination index the
// source index floor(d * scale) and the 11-bit weights of the fraction
// (d + 1) - (s + 1) * dsize / ssize, before the edge rule.
void area_linear_table(int ssize, int dsize, std::vector<int>* s, std::vector<int>* w0,
                       std::vector<int>* w1) {
    const double inv = static_cast<double>(dsize) / ssize;
    const double scale = 1.0 / inv;
    s->resize(dsize);
    w0->resize(dsize);
    w1->resize(dsize);
    for (int d = 0; d < dsize; ++d) {
        const int sx = static_cast<int>(std::floor(d * scale));
        float fx = static_cast<float>((d + 1) - (sx + 1) * inv);
        fx = fx <= 0 ? 0.f : fx - static_cast<float>(std::floor(fx));
        (*s)[d] = sx;
        (*w0)[d] = static_cast<int>(std::nearbyint((1.f - fx) * 2048.f));
        (*w1)[d] = static_cast<int>(std::nearbyint(fx * 2048.f));
    }
}

// INTER_AREA where an axis enlarges: OpenCV's linear path with the area
// weights on both axes, in its uint8 fixed point. A column whose index
// reaches the last source column takes it alone; rows read the index and
// the next one, clamped to the last row.
void resize_area_linear(const uint8_t* src, int H, int W, int C, int dh, int dw,
                        uint8_t* dst) {
    std::vector<int> xs, a0, a1, ys, b0, b1;
    area_linear_table(W, dw, &xs, &a0, &a1);
    area_linear_table(H, dh, &ys, &b0, &b1);
    for (int dx = 0; dx < dw; ++dx)
        if (xs[dx] >= W - 1) {
            xs[dx] = W - 1;
            a0[dx] = 2048;
            a1[dx] = 0;
        }
    std::vector<int> r0(static_cast<size_t>(dw) * C), r1(static_cast<size_t>(dw) * C);
    auto horizontal = [&](int y, std::vector<int>* out) {
        const uint8_t* row = src + static_cast<size_t>(y) * W * C;
        for (int dx = 0; dx < dw; ++dx) {
            const int x0 = xs[dx], x1 = std::min(xs[dx] + 1, W - 1);
            for (int c = 0; c < C; ++c)
                (*out)[dx * C + c] = row[x0 * C + c] * a0[dx] + row[x1 * C + c] * a1[dx];
        }
    };
    for (int dy = 0; dy < dh; ++dy) {
        horizontal(std::min(ys[dy], H - 1), &r0);
        horizontal(std::min(ys[dy] + 1, H - 1), &r1);
        uint8_t* out = dst + static_cast<size_t>(dy) * dw * C;
        for (size_t i = 0; i < r0.size(); ++i)
            out[i] = static_cast<uint8_t>((((b0[dy] * (r0[i] >> 4)) >> 16) +
                                           ((b1[dy] * (r1[i] >> 4)) >> 16) + 2) >> 2);
    }
}

// cv2.resize's INTER_AREA: the path OpenCV chooses from the double scale
// factors src / dst.
void resize_area(const uint8_t* src, int H, int W, int C, int dh, int dw, uint8_t* dst) {
    const double sx = 1.0 / (static_cast<double>(dw) / W);
    const double sy = 1.0 / (static_cast<double>(dh) / H);
    if (sx < 1 || sy < 1) {
        resize_area_linear(src, H, W, C, dh, dw, dst);
        return;
    }
    const double ix = std::nearbyint(sx), iy = std::nearbyint(sy);   // cvRound
    const double eps = std::numeric_limits<double>::epsilon();
    if (std::fabs(sx - ix) < eps && std::fabs(sy - iy) < eps)
        resize_area_fast(src, W, C, dh, dw, static_cast<int>(iy), static_cast<int>(ix), dst);
    else
        resize_area_general(src, H, W, C, dh, dw, sy, sx, dst);
}

void resize_nearest(const uint8_t* src, int H, int W, int C, int dh, int dw, uint8_t* dst) {
    const double ifx = 1.0 / (static_cast<double>(dw) / W);
    const double ify = 1.0 / (static_cast<double>(dh) / H);
    std::vector<int> xs(dw);
    for (int x = 0; x < dw; ++x) xs[x] = std::min(static_cast<int>(std::floor(x * ifx)), W - 1);
    for (int y = 0; y < dh; ++y) {
        const int sy = std::min(static_cast<int>(std::floor(y * ify)), H - 1);
        const uint8_t* row = src + static_cast<size_t>(sy) * W * C;
        uint8_t* out = dst + static_cast<size_t>(y) * dw * C;
        for (int x = 0; x < dw; ++x)
            for (int c = 0; c < C; ++c) out[x * C + c] = row[xs[x] * C + c];
    }
}

// OpenCV's interpolateCubic (A = -0.75), in float.
void cubic_coeffs(float x, float* c) {
    const float A = -0.75f;
    c[0] = ((A * (x + 1.f) - 5.f * A) * (x + 1.f) + 8.f * A) * (x + 1.f) - 4.f * A;
    c[1] = ((A + 2.f) * x - (A + 3.f)) * x * x + 1.f;
    const float y = 1.f - x;
    c[2] = ((A + 2.f) * y - (A + 3.f)) * y * y + 1.f;
    c[3] = 1.f - c[0] - c[1] - c[2];
}

// First source index and 4 weights per destination index.
void cubic_table(int ssize, int dsize, std::vector<int>* first, std::vector<float>* w) {
    const double scale = 1.0 / (static_cast<double>(dsize) / ssize);
    first->resize(dsize);
    w->resize(4 * static_cast<size_t>(dsize));
    for (int d = 0; d < dsize; ++d) {
        const float f = static_cast<float>((d + 0.5) * scale - 0.5);
        const int s = static_cast<int>(std::floor(f));
        (*first)[d] = s;
        cubic_coeffs(f - static_cast<float>(s), w->data() + 4 * d);
    }
}

void resize_cubic(const uint8_t* src, int H, int W, int C, int dh, int dw, uint8_t* dst) {
    std::vector<int> sx, sy;
    std::vector<float> wx, wy;
    cubic_table(W, dw, &sx, &wx);
    cubic_table(H, dh, &sy, &wy);
    // horizontal pass over every source row, edge replicated
    std::vector<float> hbuf(static_cast<size_t>(H) * dw * C);
    for (int y = 0; y < H; ++y) {
        const uint8_t* row = src + static_cast<size_t>(y) * W * C;
        float* h = hbuf.data() + static_cast<size_t>(y) * dw * C;
        for (int x = 0; x < dw; ++x) {
            int cols[4];
            for (int k = 0; k < 4; ++k) cols[k] = std::min(std::max(sx[x] - 1 + k, 0), W - 1);
            const float* w = wx.data() + 4 * x;
            for (int c = 0; c < C; ++c) {
                float v = static_cast<float>(row[cols[0] * C + c]) * w[0];
                for (int k = 1; k < 4; ++k) v = v + static_cast<float>(row[cols[k] * C + c]) * w[k];
                h[x * C + c] = v;
            }
        }
    }
    const size_t n = static_cast<size_t>(dw) * C;
    for (int y = 0; y < dh; ++y) {
        const float* r[4];
        for (int k = 0; k < 4; ++k)
            r[k] = hbuf.data() + static_cast<size_t>(std::min(std::max(sy[y] - 1 + k, 0), H - 1)) * n;
        const float* w = wy.data() + 4 * y;
        uint8_t* out = dst + static_cast<size_t>(y) * n;
        for (size_t i = 0; i < n; ++i) {
            float v = r[0][i] * w[0];
            for (int k = 1; k < 4; ++k) v = v + r[k][i] * w[k];
            out[i] = round_u8(v);
        }
    }
}

}  // namespace

// ---------------------------------------------------------------------------
// The C interface

FRTM_EXPORT const char* frtm_host_jpeg_backend() { return BACKEND; }

// cv2.dilate(mask, getStructuringElement(MORPH_ELLIPSE, (2, 2))): the element
// is [[0, 1], [1, 1]] anchored at (1, 1), so a pixel takes the max of itself,
// its left and its upper neighbour. 16 pixels at a time in GCC's vector
// extension (-O2 does not vectorise the scalar loop on every GCC); out may not
// alias mask.
FRTM_EXPORT int dilate_ellipse2_u8(const uint8_t* mask, int h, int w, uint8_t* out) {
    typedef uint8_t v16 __attribute__((vector_size(16)));
    auto load = [](const uint8_t* p) { v16 v; std::memcpy(&v, p, 16); return v; };
    auto vmax = [](v16 a, v16 b) { return a > b ? a : b; };
    if (h <= 0 || w <= 0) return -1;
    std::vector<uint8_t> zeros(w, 0);
    for (int y = 0; y < h; ++y) {
        const uint8_t* m = mask + static_cast<size_t>(y) * w;
        const uint8_t* up = y ? m - w : zeros.data();
        uint8_t* o = out + static_cast<size_t>(y) * w;
        o[0] = std::max(m[0], up[0]);
        int x = 1;
        for (; x + 16 <= w; x += 16) {
            const v16 v = vmax(vmax(load(m + x), load(m + x - 1)), load(up + x));
            std::memcpy(o + x, &v, 16);
        }
        for (; x < w; ++x) o[x] = std::max(std::max(m[x], m[x - 1]), up[x]);
    }
    return 0;
}

// cv2.inpaint(image, mask, radius, INPAINT_TELEA) for (h, w, 3) uint8 images;
// mask nonzero marks the hole. out may not alias img.
FRTM_EXPORT int inpaint_telea_u8c3(const uint8_t* img, const uint8_t* mask, int h, int w,
                                   int radius, uint8_t* out) {
    if (h <= 0 || w <= 0) return -1;
    radius = std::min(std::max(radius, 1), 100);
    std::memcpy(out, img, static_cast<size_t>(h) * w * 3);
    const int rows = h + 2, cols = w + 2;
    const size_t n = static_cast<size_t>(rows) * cols;
    std::vector<uint8_t> hole(n, 0);
    bool any = false;
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            if (mask[static_cast<size_t>(y) * w + x]) {
                hole[static_cast<size_t>(y + 1) * cols + x + 1] = INSIDE;
                any = true;
            }
    if (!any) return 0;

    std::vector<uint8_t> band(n), ring(n);
    dilate(hole.data(), rows, cols, 1, true, band.data());
    dilate(hole.data(), rows, cols, radius, false, ring.data());
    auto border = [&](int i, int j) { return i == 0 || j == 0 || i == rows - 1 || j == cols - 1; };
    Grid g{rows, cols, std::vector<uint8_t>(n, KNOWN), std::vector<float>(n, 1.0e6f)};
    std::vector<std::pair<int, int>> seeds;  // raster order, as OpenCV adds them
    for (int i = 0; i < rows; ++i) {
        for (int j = 0; j < cols; ++j) {
            const size_t p = static_cast<size_t>(i) * cols + j;
            band[p] = border(i, j) ? 0 : static_cast<uint8_t>(band[p] - hole[p]);
            ring[p] = (border(i, j) || band[p]) ? 0 : static_cast<uint8_t>(ring[p] - hole[p]);
            if (band[p]) {
                seeds.emplace_back(i, j);
                g.f[p] = BAND;
                g.t[p] = 0.0f;
            }
            if (hole[p]) g.f[p] = INSIDE;
        }
    }
    march_outward(ring, g.t, rows, cols, seeds);

    Band heap;
    int64_t count = 0;
    for (const auto& s : seeds) heap.push({0.0f, count++, s.first, s.second});
    while (!heap.empty()) {
        const BandEntry e = heap.top();
        heap.pop();
        g.F(e.i, e.j) = KNOWN;
        for (const auto& d : NEIGHBOURS) {
            const int i = e.i + d[0], j = e.j + d[1];
            if (i <= 0 || j <= 0 || i > rows - 1 || j > cols - 1) continue;
            if (g.F(i, j) != INSIDE) continue;
            const float dist = arrival(g.f.data(), g.t.data(), cols, i, j);
            g.T(i, j) = dist;
            float gx, gy;
            grad_t(g, i, j, &gx, &gy);
            fill(g, out, w, i, j, radius, gx, gy);
            g.F(i, j) = BAND;
            heap.push({dist, count++, i, j});
        }
    }
    return 0;
}

// src (H, W, C) -> dst (dh, dw, C), uint8; mode 0 nearest, 1 area, 2 cubic.
// Returns 0, or -1 for bad sizes.
FRTM_EXPORT int resize_u8(const uint8_t* src, int H, int W, int C, int dh, int dw, int mode,
                          uint8_t* dst) {
    if (H <= 0 || W <= 0 || C <= 0 || dh <= 0 || dw <= 0) return -1;
    if (mode == 0) {
        resize_nearest(src, H, W, C, dh, dw, dst);
    } else if (mode == 1) {
        resize_area(src, H, W, C, dh, dw, dst);
    } else if (mode == 2) {
        resize_cubic(src, H, W, C, dh, dw, dst);
    } else {
        return -1;
    }
    return 0;
}

// The (h, w, channels) samples of a PNG's inflated image data: each pass
// (the whole image, or the seven Adam7 passes when interlaced) unfiltered on
// its own with a byte step of max(1, depth * channels / 8), its samples
// unpacked and put in their places. out holds uint8 samples for depths 1-8,
// uint16 (native order) for 16. Returns 0, -1 for bad arguments or a size
// mismatch, or -(2 + i) for an unknown filter type at byte i of raw.
FRTM_EXPORT long png_samples(const uint8_t* raw, long raw_len, int h, int w, int depth,
                             int channels, int interlace, uint8_t* out) {
    if (h <= 0 || w <= 0 || channels < 1 || channels > 4 || (interlace != 0 && interlace != 1) ||
        (depth != 1 && depth != 2 && depth != 4 && depth != 8 && depth != 16))
        return -1;
    const std::vector<PngPass> passes = png_passes(h, w, interlace == 1);
    // a row's bytes in 64 bits: a width of up to 2^31 - 1 at 64 bits a pixel
    auto stride = [&](const PngPass& p) {
        return (static_cast<int64_t>(p.cols) * channels * depth + 7) / 8;
    };
    int64_t total = 0;
    for (const PngPass& p : passes) total += p.rows * (stride(p) + 1);
    if (total != raw_len) return -1;
    // non-interlaced 8-bit rows are the samples themselves
    const bool direct = interlace == 0 && depth == 8;
    const int bpp = std::max(1, depth * channels / 8);
    std::vector<uint8_t> lines;
    uint16_t* out16 = reinterpret_cast<uint16_t*>(out);
    int64_t pos = 0;
    for (const PngPass& p : passes) {
        const int64_t st = stride(p);
        if (!direct) lines.resize(static_cast<size_t>(p.rows) * st);
        const int bad = unfilter_rows(raw + pos, p.rows, st, bpp, direct ? out : lines.data());
        if (bad >= 0) return -(2 + pos + bad * (st + 1));
        for (int r = 0; r < p.rows && !direct; ++r) {
            const uint8_t* line = lines.data() + static_cast<size_t>(r) * st;
            const size_t base = (static_cast<size_t>(p.y0) + static_cast<size_t>(r) * p.dy) * w;
            for (int col = 0; col < p.cols; ++col) {
                const size_t o = (base + p.x0 + static_cast<size_t>(col) * p.dx) * channels;
                for (int ch = 0; ch < channels; ++ch) {
                    const unsigned v = sample(line, static_cast<long>(col) * channels + ch, depth);
                    if (depth == 16)
                        out16[o + ch] = static_cast<uint16_t>(v);
                    else
                        out[o + ch] = static_cast<uint8_t>(v);
                }
            }
        }
        pos += p.rows * (st + 1);
    }
    return 0;
}

// The size of a JPEG image from its header.
FRTM_EXPORT int jpeg_dims(const uint8_t* buf, long len, int* h, int* w, char* err, int errlen) {
    return dims(buf, len, h, w, err, errlen);
}

// Decode a JPEG image to (h, w, 3) RGB; h and w must be its size.
FRTM_EXPORT int decode_jpeg(const uint8_t* buf, long len, uint8_t* out, int h, int w, char* err,
                            int errlen) {
#if defined(FRTM_HOST_NVJPEG)
    if (!handle(err, errlen)) return -1;
    thread_local Decoder dec;
#else
    Decoder dec;
#endif
    return dec.decode(buf, len, out, h, w, err, errlen);
}

#if defined(FRTM_HOST_LIBJPEG)
// decode_jpeg through libjpeg's planes and ycc_planes_to_rgb, the nvJPEG
// build's conversion (for the tests; libjpeg builds only).
FRTM_EXPORT int decode_jpeg_planar(const uint8_t* buf, long len, uint8_t* out, int h, int w,
                                   char* err, int errlen) {
    return jpeg_planar(buf, len, out, h, w, err, errlen);
}
#endif

// Decode n same-size JPEG files, (h, w, 3) each, into out (n, h, w, 3) on
// n_threads threads. status[i] is 0 for each file decoded, else non-zero.
// Returns the number of files that failed.
FRTM_EXPORT int batch_decode_jpeg_files(const char** paths, int n, uint8_t* out, int h, int w,
                                        int n_threads, int* status) {
#if defined(FRTM_HOST_NVJPEG)
    char err0[256];
    if (!handle(err0, sizeof(err0))) {
        for (int i = 0; i < n; ++i) status[i] = -1;
        return n;
    }
#endif
    std::atomic<int> next(0), failed(0);
    auto worker = [&]() {
        Decoder dec;
        std::vector<uint8_t> buf;
        char err[256];
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n) break;
            int rc = read_file(paths[i], &buf) ? 0 : -4;
            if (rc == 0)
                rc = dec.decode(buf.data(), static_cast<long>(buf.size()),
                                out + static_cast<size_t>(i) * h * w * 3, h, w, err, sizeof(err));
            status[i] = rc;
            if (rc != 0) failed.fetch_add(1);
        }
    };
    const int nt = std::max(1, std::min(n_threads, n));
    std::vector<std::thread> threads;
    for (int i = 1; i < nt; ++i) threads.emplace_back(worker);
    worker();
    for (auto& t : threads) t.join();
    return failed.load();
}
