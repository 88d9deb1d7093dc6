// Native dataset runtime of the PyTorch port: EuRoC/TUM-VI-format readers
// with threaded prefetch (a copy of rover_slam_tpu/native/dataset_loader.cc,
// built by rover_slam_tpu_torch/utils/dataset.py into the port's _build/).
//
// The host IO the reference does inline in its example mains and OpenCV
// (EuRoC mav0/cam0/data.csv + image files and imu0/data.csv; cv::imread):
// a pthread prefetcher decodes images ahead into a ring of buffers while the
// GPU computes.
//
// Formats: 8-bit grayscale PNG (decoded via libpng when its header is
// present at build time; color inputs are converted to luma), 8-bit binary
// PGM (P5), EuRoC-style CSV (timestamp_ns,filename / IMU rows). Image readers
// dispatch on the file magic, not the extension. Exposed via a C ABI for
// ctypes; `dataset_has_png()` says whether PNG decode was built in.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -lpng (or -DDATASET_NO_PNG)

#if __has_include(<png.h>) && !defined(DATASET_NO_PNG)
#include <png.h>
#define DATASET_HAVE_PNG 1
#else
#define DATASET_HAVE_PNG 0
#endif

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <array>
#include <vector>
#include <thread>
#include <mutex>
#include <condition_variable>
#include <atomic>

namespace {

struct Csv {
  std::vector<double> ts;               // seconds
  std::vector<std::string> fields;      // first string field (filename)
  std::vector<std::array<double, 6>> vals;  // numeric fields (IMU)
};

bool parse_csv(const char* path, bool numeric, Csv* out) {
  FILE* f = std::fopen(path, "r");
  if (!f) return false;
  char line[1024];
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == '#' || line[0] == '\n') continue;
    char* save = nullptr;
    char* tok = strtok_r(line, ",", &save);
    if (!tok) continue;
    double t_ns = std::strtod(tok, nullptr);
    out->ts.push_back(t_ns * 1e-9);
    if (numeric) {
      std::array<double, 6> v{};
      for (int i = 0; i < 6; i++) {
        tok = strtok_r(nullptr, ",\r\n", &save);
        v[i] = tok ? std::strtod(tok, nullptr) : 0.0;
      }
      out->vals.push_back(v);
    } else {
      tok = strtok_r(nullptr, ",\r\n ", &save);
      out->fields.push_back(tok ? tok : "");
    }
  }
  std::fclose(f);
  return true;
}

// Minimal binary PGM (P5) decode.
bool read_pgm(const std::string& path, std::vector<uint8_t>* data,
              int* w, int* h) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  char magic[3] = {0};
  if (std::fscanf(f, "%2s", magic) != 1 || std::strcmp(magic, "P5") != 0) {
    std::fclose(f);
    return false;
  }
  int maxv = 0;
  // Skip comments/whitespace while reading header ints.
  auto read_int = [&](int* v) {
    int c;
    do {
      c = std::fgetc(f);
      if (c == '#') { while (c != '\n' && c != EOF) c = std::fgetc(f); }
    } while (c == ' ' || c == '\n' || c == '\t' || c == '\r' || c == '#');
    std::ungetc(c, f);
    return std::fscanf(f, "%d", v) == 1;
  };
  if (!read_int(w) || !read_int(h) || !read_int(&maxv)) {
    std::fclose(f);
    return false;
  }
  std::fgetc(f);  // single whitespace after maxval
  data->resize(size_t(*w) * size_t(*h));
  size_t n = std::fread(data->data(), 1, data->size(), f);
  std::fclose(f);
  return n == data->size();
}

// 8-bit grayscale PNG decode via the libpng simplified API; color PNGs are
// converted to single-channel luma (what cv::imread(..., IMREAD_GRAYSCALE)
// gives the reference's mains).
bool read_png(const std::string& path, std::vector<uint8_t>* data,
              int* w, int* h) {
#if DATASET_HAVE_PNG
  png_image img;
  std::memset(&img, 0, sizeof img);
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&img, path.c_str())) return false;
  img.format = PNG_FORMAT_GRAY;
  *w = int(img.width);
  *h = int(img.height);
  data->resize(PNG_IMAGE_SIZE(img));
  if (!png_image_finish_read(&img, nullptr, data->data(), 0, nullptr)) {
    png_image_free(&img);
    return false;
  }
  return true;
#else
  (void)path; (void)data; (void)w; (void)h;
  return false;
#endif
}

// Dispatch on file magic: \x89PNG -> PNG, "P5" -> PGM.
bool read_image(const std::string& path, std::vector<uint8_t>* data,
                int* w, int* h) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  unsigned char magic[2] = {0, 0};
  size_t n = std::fread(magic, 1, 2, f);
  std::fclose(f);
  if (n != 2) return false;
  if (magic[0] == 0x89 && magic[1] == 'P') return read_png(path, data, w, h);
  return read_pgm(path, data, w, h);
}

struct Prefetcher {
  std::vector<std::string> paths;
  int width = 0, height = 0;
  size_t next_submit = 0;
  size_t capacity = 0;
  std::vector<std::vector<uint8_t>> ring;
  std::vector<std::atomic<int>> state;  // 0 empty, 1 ready, 2 failed
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};
  size_t consumed = 0;

  Prefetcher(std::vector<std::string> p, size_t depth)
      : paths(std::move(p)), capacity(depth), ring(depth),
        state(depth) {
    for (auto& s : state) s.store(0);
    worker = std::thread([this] { run(); });
  }

  ~Prefetcher() {
    stop.store(true);
    cv.notify_all();
    if (worker.joinable()) worker.join();
  }

  void run() {
    for (size_t i = 0; i < paths.size() && !stop.load(); i++) {
      size_t slot = i % capacity;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop.load() || state[slot].load() == 0;
        });
        if (stop.load()) return;
      }
      int w = 0, h = 0;
      bool ok = read_image(paths[i], &ring[slot], &w, &h);
      if (ok) { width = w; height = h; }
      state[slot].store(ok ? 1 : 2);
      cv.notify_all();
    }
  }

  // Blocking fetch of image `idx` (must be consumed in order).
  int fetch(size_t idx, uint8_t* dst, size_t dst_size) {
    if (idx >= paths.size()) return -1;
    size_t slot = idx % capacity;
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [&] { return state[slot].load() != 0; });
    int st = state[slot].load();
    if (st == 1) {
      size_t n = ring[slot].size() < dst_size ? ring[slot].size() : dst_size;
      std::memcpy(dst, ring[slot].data(), n);
    }
    state[slot].store(0);
    cv.notify_all();
    return st == 1 ? 0 : -2;
  }
};

}  // namespace

extern "C" {

int dataset_has_png() { return DATASET_HAVE_PNG; }

// ---- CSV ----
void* csv_open(const char* path, int numeric) {
  auto* c = new Csv();
  if (!parse_csv(path, numeric != 0, c)) {
    delete c;
    return nullptr;
  }
  return c;
}
long csv_size(void* h) { return ((Csv*)h)->ts.size(); }
void csv_timestamps(void* h, double* out) {
  auto* c = (Csv*)h;
  std::memcpy(out, c->ts.data(), c->ts.size() * sizeof(double));
}
void csv_values(void* h, double* out) {  // [n,6] IMU values
  auto* c = (Csv*)h;
  for (size_t i = 0; i < c->vals.size(); i++)
    std::memcpy(out + 6 * i, c->vals[i].data(), 6 * sizeof(double));
}
int csv_field(void* h, long i, char* out, int cap) {
  auto* c = (Csv*)h;
  if (i < 0 || size_t(i) >= c->fields.size()) return -1;
  std::snprintf(out, cap, "%s", c->fields[i].c_str());
  return 0;
}
void csv_close(void* h) { delete (Csv*)h; }

// ---- single image read (PNG or PGM, by magic) ----
int image_read(const char* path, uint8_t* dst, long cap, int* w, int* h) {
  std::vector<uint8_t> buf;
  if (!read_image(path, &buf, w, h)) return -1;
  if ((long)buf.size() > cap) return -2;
  std::memcpy(dst, buf.data(), buf.size());
  return 0;
}

// Kept for ABI compatibility; now also accepts PNG.
int pgm_read(const char* path, uint8_t* dst, long cap, int* w, int* h) {
  return image_read(path, dst, cap, w, h);
}

// ---- Threaded prefetcher ----
void* prefetch_open(const char** paths, long n, long depth) {
  std::vector<std::string> p(paths, paths + n);
  return new Prefetcher(std::move(p), size_t(depth));
}
int prefetch_fetch(void* h, long idx, uint8_t* dst, long cap) {
  return ((Prefetcher*)h)->fetch(size_t(idx), dst, size_t(cap));
}
int prefetch_width(void* h) { return ((Prefetcher*)h)->width; }
int prefetch_height(void* h) { return ((Prefetcher*)h)->height; }
void prefetch_close(void* h) { delete (Prefetcher*)h; }

}  // extern "C"
