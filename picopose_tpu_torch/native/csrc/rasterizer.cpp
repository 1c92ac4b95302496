// Software template renderer: perspective triangle rasterizer with z-buffer.
//
// Host-side replacement for the reference's offline rendering toolchain,
// which shells out to the Panda3D C++ engine / Blender per CAD model
// (rendering/scripts/render_bop_templates.py:119-138,
//  rendering/src/custom_megapose/call_panda3d.py): render RGBA + depth for a
// set of template viewpoints at 640x480 with a fixed K.  Instead of an
// external engine + subprocess fan-out, this is a self-contained rasterizer
// driven through ctypes (picopose_tpu_torch/native/renderer.py) with
// std::thread parallelism across views.  The port's copy of the JAX
// package's native/rasterizer.cpp.
//
// Conventions (matching the bank contract, provider/bop_test_dataset.py:
// 212-264): OpenCV camera (+z forward), pose = camera-from-model (mm),
// output RGBA uint8 (A = coverage) and depth uint16 in mm.
//
// Shading: Lambertian w.r.t. the camera direction plus an ambient floor, on
// UV-sampled texture color when the mesh carries a texture (GSO/ShapeNet OBJ,
// textured BOP PLYs — reference renders these through Panda3D:
// rendering/src/custom_megapose/call_panda3d.py:29-60), else on vertex colors
// when the mesh has them (most BOP CADs), else a neutral albedo — equivalent
// signal to the reference's ambient-lit Panda3D renders for template matching.
//
// UVs are passed PER FACE CORNER ((n_faces, 3, 2) float32) rather than per
// vertex: OBJ meshes index positions and texcoords independently, so a single
// position vertex can carry different UVs on different faces; per-corner UVs
// represent that without vertex duplication.  Texture sampling is
// perspective-correct bilinear with repeat wrapping (v = 0 at the TOP row:
// loaders flip OBJ's bottom-left-origin vt coordinates before the call).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 sub(const Vec3& a, const Vec3& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float dot(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
inline Vec3 normalize(const Vec3& v) {
  float n = std::sqrt(dot(v, v));
  if (n < 1e-12f) return {0, 0, 1};
  return {v.x / n, v.y / n, v.z / n};
}

struct Framebuffer {
  int W, H;
  std::vector<float> depth;    // camera z, +inf = empty
  std::vector<uint8_t> rgba;   // H*W*4

  Framebuffer(int w, int h) : W(w), H(h), depth(w * h, 1e30f), rgba(w * h * 4, 0) {}
};

struct Texture {
  const uint8_t* data;  // (h, w, 3) uint8, row-major, v=0 at top
  int w, h;

  // bilinear sample with repeat wrap; uv in texture coords ([0,1] maps to
  // the full image, pixel centers at (i + 0.5) / size)
  void sample(float u, float v, float* rgb) const {
    float x = u * w - 0.5f, y = v * h - 0.5f;
    int x0 = (int)std::floor(x), y0 = (int)std::floor(y);
    float fx = x - x0, fy = y - y0;
    auto wrap = [](int i, int n) {
      int m = i % n;
      return m < 0 ? m + n : m;
    };
    int xa = wrap(x0, w), xb = wrap(x0 + 1, w);
    int ya = wrap(y0, h), yb = wrap(y0 + 1, h);
    for (int c = 0; c < 3; ++c) {
      float t00 = data[3 * (ya * w + xa) + c], t01 = data[3 * (ya * w + xb) + c];
      float t10 = data[3 * (yb * w + xa) + c], t11 = data[3 * (yb * w + xb) + c];
      float top = t00 + fx * (t01 - t00);
      float bot = t10 + fx * (t11 - t10);
      rgb[c] = (top + fy * (bot - top)) / 255.0f;
    }
  }
};

void rasterize_view(
    const float* verts, const float* colors, int n_verts,
    const int32_t* faces, int n_faces,
    const float* uv,          // (n_faces, 3, 2) per-corner UVs or nullptr
    const Texture* tex,       // nullptr when untextured
    const float* K, const float* pose,  // 3x3 row-major, 4x4 row-major
    Framebuffer& fb) {
  // transform vertices to camera frame
  std::vector<Vec3> cam(n_verts);
  for (int i = 0; i < n_verts; ++i) {
    const float* v = verts + 3 * i;
    for (int r = 0; r < 3; ++r) {
      (&cam[i].x)[r] = pose[4 * r + 0] * v[0] + pose[4 * r + 1] * v[1] +
                       pose[4 * r + 2] * v[2] + pose[4 * r + 3];
    }
  }
  const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  std::vector<float> px(n_verts), py(n_verts);
  for (int i = 0; i < n_verts; ++i) {
    float z = std::max(cam[i].z, 1e-6f);
    px[i] = fx * cam[i].x / z + cx;
    py[i] = fy * cam[i].y / z + cy;
  }

  for (int f = 0; f < n_faces; ++f) {
    int a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
    if (cam[a].z <= 1e-6f || cam[b].z <= 1e-6f || cam[c].z <= 1e-6f) continue;

    float x0 = px[a], y0 = py[a], x1 = px[b], y1 = py[b], x2 = px[c], y2 = py[c];
    float area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
    if (std::fabs(area) < 1e-12f) continue;

    int minx = std::max(0, (int)std::floor(std::min({x0, x1, x2})));
    int maxx = std::min(fb.W - 1, (int)std::ceil(std::max({x0, x1, x2})));
    int miny = std::max(0, (int)std::floor(std::min({y0, y1, y2})));
    int maxy = std::min(fb.H - 1, (int)std::ceil(std::max({y0, y1, y2})));
    if (minx > maxx || miny > maxy) continue;

    // shading: lambert vs view direction on the face normal
    Vec3 n = normalize(cross(sub(cam[b], cam[a]), sub(cam[c], cam[a])));
    Vec3 centroid = {(cam[a].x + cam[b].x + cam[c].x) / 3.0f,
                     (cam[a].y + cam[b].y + cam[c].y) / 3.0f,
                     (cam[a].z + cam[b].z + cam[c].z) / 3.0f};
    Vec3 viewdir = normalize(centroid);
    float lambert = std::fabs(dot(n, viewdir));
    float shade = 0.35f + 0.65f * lambert;

    float inv_area = 1.0f / area;
    float iz0 = 1.0f / cam[a].z, iz1 = 1.0f / cam[b].z, iz2 = 1.0f / cam[c].z;

    for (int y = miny; y <= maxy; ++y) {
      for (int x = minx; x <= maxx; ++x) {
        float pxc = x + 0.5f, pyc = y + 0.5f;
        float w0 = ((x1 - pxc) * (y2 - pyc) - (x2 - pxc) * (y1 - pyc)) * inv_area;
        float w1 = ((x2 - pxc) * (y0 - pyc) - (x0 - pxc) * (y2 - pyc)) * inv_area;
        float w2 = 1.0f - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        // perspective-correct depth
        float iz = w0 * iz0 + w1 * iz1 + w2 * iz2;
        float z = 1.0f / iz;
        int idx = y * fb.W + x;
        if (z >= fb.depth[idx]) continue;
        fb.depth[idx] = z;

        float r = 0.7f, g = 0.7f, bcol = 0.7f;
        if (tex && uv) {
          // perspective-correct UV interpolation + bilinear texture sample
          float cw0 = w0 * iz0 * z, cw1 = w1 * iz1 * z, cw2 = w2 * iz2 * z;
          const float* fuv = uv + 6 * f;
          float u_ = cw0 * fuv[0] + cw1 * fuv[2] + cw2 * fuv[4];
          float v_ = cw0 * fuv[1] + cw1 * fuv[3] + cw2 * fuv[5];
          float rgb[3];
          tex->sample(u_, v_, rgb);
          r = rgb[0];
          g = rgb[1];
          bcol = rgb[2];
        } else if (colors) {
          // perspective-correct vertex color interpolation
          float cw0 = w0 * iz0 * z, cw1 = w1 * iz1 * z, cw2 = w2 * iz2 * z;
          r = cw0 * colors[3 * a] + cw1 * colors[3 * b] + cw2 * colors[3 * c];
          g = cw0 * colors[3 * a + 1] + cw1 * colors[3 * b + 1] + cw2 * colors[3 * c + 1];
          bcol = cw0 * colors[3 * a + 2] + cw1 * colors[3 * b + 2] + cw2 * colors[3 * c + 2];
        }
        auto to8 = [&](float v) {
          return (uint8_t)std::clamp(v * shade * 255.0f, 0.0f, 255.0f);
        };
        fb.rgba[4 * idx] = to8(r);
        fb.rgba[4 * idx + 1] = to8(g);
        fb.rgba[4 * idx + 2] = to8(bcol);
        fb.rgba[4 * idx + 3] = 255;
      }
    }
  }
}

}  // namespace

extern "C" {

// Render n_views templates of one mesh (textured variant).
//   verts   (n_verts, 3) float32, model units (mm for BOP CADs)
//   colors  (n_verts, 3) float32 in [0, 1] or nullptr
//   faces   (n_faces, 3) int32
//   uv      (n_faces, 3, 2) float32 per-corner texcoords or nullptr
//   texture (tex_h, tex_w, 3) uint8 (v=0 at top) or nullptr
//   K       (3, 3) float32 row-major
//   poses   (n_views, 4, 4) float32 camera-from-model
//   out_rgba  (n_views, H, W, 4) uint8
//   out_depth (n_views, H, W) uint16, mm (clamped at 65535)
// Color priority per face: texture (when uv+texture given) > vertex colors >
// neutral 0.7 albedo; all shaded by the same ambient+lambert term.
void render_templates_tex(
    const float* verts, const float* colors, int n_verts,
    const int32_t* faces, int n_faces,
    const float* uv, const uint8_t* texture, int tex_w, int tex_h,
    const float* K, const float* poses, int n_views,
    int W, int H, int n_threads,
    uint8_t* out_rgba, uint16_t* out_depth) {
  Texture tex{texture, tex_w, tex_h};
  const Texture* tex_p = (texture && uv && tex_w > 0 && tex_h > 0) ? &tex : nullptr;
  std::atomic<int> next{0};
  auto work = [&]() {
    while (true) {
      int v = next.fetch_add(1);
      if (v >= n_views) return;
      Framebuffer fb(W, H);
      rasterize_view(verts, colors, n_verts, faces, n_faces,
                     tex_p ? uv : nullptr, tex_p, K, poses + 16 * v, fb);
      std::memcpy(out_rgba + (size_t)v * H * W * 4, fb.rgba.data(),
                  (size_t)H * W * 4);
      uint16_t* d = out_depth + (size_t)v * H * W;
      for (int i = 0; i < H * W; ++i) {
        float z = fb.depth[i];
        d[i] = (z > 1e29f) ? 0 : (uint16_t)std::clamp(z, 0.0f, 65535.0f);
      }
    }
  };
  int nt = std::max(1, n_threads);
  std::vector<std::thread> threads;
  for (int i = 0; i < nt; ++i) threads.emplace_back(work);
  for (auto& t : threads) t.join();
}

// Untextured entry (kept for ABI stability with older callers).
void render_templates(
    const float* verts, const float* colors, int n_verts,
    const int32_t* faces, int n_faces,
    const float* K, const float* poses, int n_views,
    int W, int H, int n_threads,
    uint8_t* out_rgba, uint16_t* out_depth) {
  render_templates_tex(verts, colors, n_verts, faces, n_faces,
                       nullptr, nullptr, 0, 0, K, poses, n_views,
                       W, H, n_threads, out_rgba, out_depth);
}

}  // extern "C"
