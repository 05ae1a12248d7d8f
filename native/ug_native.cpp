// ug_native — native host-side runtime for ug_stereomatcher.
//
// The reference implements its host runtime in C++ (ROS nodes, OpenCV/PCL
// plumbing, getPointCloud.cpp's reconstruction + pcl PCD writer).  This
// library is the framework's native counterpart for the host-side hot
// paths that sit outside XLA:
//
//   * point-cloud packing + binary PCD/PLY serialisation (millions of
//     points per 16MP frame; replaces pcl::io::savePCDFileASCII,
//     getPointCloud.cpp:330)
//   * PPM/PGM image encode/decode (zero-dependency raw stereo IO)
//   * a pthread ring-buffer file prefetcher feeding the engine (replaces
//     the publish_images capture process + TCPROS hop)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Point-cloud packing + serialisation
// ---------------------------------------------------------------------

// Pack xyz (n x 3 float32) + rgb (n x 3 uint8) into interleaved PCD
// records [x, y, z, packed_rgb_float] (PCL layout: 0x00RRGGBB bit-cast to
// float — getPointCloud.cpp:660-666).  out must hold n*4 floats.
void ug_pack_xyzrgb(const float* xyz, const uint8_t* rgb, int64_t n,
                    float* out) {
    for (int64_t i = 0; i < n; ++i) {
        out[i * 4 + 0] = xyz[i * 3 + 0];
        out[i * 4 + 1] = xyz[i * 3 + 1];
        out[i * 4 + 2] = xyz[i * 3 + 2];
        uint32_t packed = (uint32_t(rgb[i * 3 + 0]) << 16) |
                          (uint32_t(rgb[i * 3 + 1]) << 8) |
                          uint32_t(rgb[i * 3 + 2]);
        float f;
        std::memcpy(&f, &packed, sizeof(f));
        out[i * 4 + 3] = f;
    }
}

// Write a binary PCD (x y z rgb float fields).  Returns 0 on success.
int ug_write_pcd(const char* path, const float* xyz, const uint8_t* rgb,
                 int64_t n) {
    FILE* fh = std::fopen(path, "wb");
    if (!fh) return -1;
    std::string header =
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z rgb\n"
        "SIZE 4 4 4 4\n"
        "TYPE F F F F\n"
        "COUNT 1 1 1 1\n"
        "WIDTH " + std::to_string(n) + "\nHEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        "POINTS " + std::to_string(n) + "\nDATA binary\n";
    if (std::fwrite(header.data(), 1, header.size(), fh) != header.size()) {
        std::fclose(fh);
        return -2;
    }
    // stream in chunks so we never allocate n*16 bytes twice
    const int64_t kChunk = 1 << 18;
    std::vector<float> buf(kChunk * 4);
    for (int64_t off = 0; off < n; off += kChunk) {
        int64_t m = std::min(kChunk, n - off);
        ug_pack_xyzrgb(xyz + off * 3, rgb + off * 3, m, buf.data());
        if (std::fwrite(buf.data(), sizeof(float) * 4, m, fh) != size_t(m)) {
            std::fclose(fh);
            return -3;
        }
    }
    std::fclose(fh);
    return 0;
}

// Write a binary little-endian PLY with uchar colours.  Returns 0 on success.
int ug_write_ply(const char* path, const float* xyz, const uint8_t* rgb,
                 int64_t n) {
    FILE* fh = std::fopen(path, "wb");
    if (!fh) return -1;
    std::string header =
        "ply\nformat binary_little_endian 1.0\n"
        "element vertex " + std::to_string(n) + "\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n";
    if (std::fwrite(header.data(), 1, header.size(), fh) != header.size()) {
        std::fclose(fh);
        return -2;
    }
    const int64_t kChunk = 1 << 18;
    std::vector<uint8_t> buf(kChunk * 15);
    for (int64_t off = 0; off < n; off += kChunk) {
        int64_t m = std::min(kChunk, n - off);
        uint8_t* p = buf.data();
        for (int64_t i = 0; i < m; ++i) {
            std::memcpy(p, xyz + (off + i) * 3, 12);
            std::memcpy(p + 12, rgb + (off + i) * 3, 3);
            p += 15;
        }
        if (std::fwrite(buf.data(), 15, m, fh) != size_t(m)) {
            std::fclose(fh);
            return -3;
        }
    }
    std::fclose(fh);
    return 0;
}

// ---------------------------------------------------------------------
// PPM (P6) encode/decode — dependency-free stereo image IO
// ---------------------------------------------------------------------

// Read header of a P6 PPM; returns 0 and fills w/h on success.
int ug_ppm_probe(const char* path, int32_t* w, int32_t* h) {
    FILE* fh = std::fopen(path, "rb");
    if (!fh) return -1;
    int ww, hh, maxv;
    if (std::fscanf(fh, "P6 %d %d %d", &ww, &hh, &maxv) != 3 || maxv != 255) {
        std::fclose(fh);
        return -2;
    }
    *w = ww;
    *h = hh;
    std::fclose(fh);
    return 0;
}

// Read P6 pixel data into out (h*w*3 bytes).
int ug_ppm_read(const char* path, uint8_t* out, int64_t cap) {
    FILE* fh = std::fopen(path, "rb");
    if (!fh) return -1;
    int w, h, maxv;
    if (std::fscanf(fh, "P6 %d %d %d", &w, &h, &maxv) != 3 || maxv != 255) {
        std::fclose(fh);
        return -2;
    }
    std::fgetc(fh);  // single whitespace after maxval
    int64_t need = int64_t(w) * h * 3;
    if (need > cap) {
        std::fclose(fh);
        return -3;
    }
    int64_t got = (int64_t)std::fread(out, 1, need, fh);
    std::fclose(fh);
    return got == need ? 0 : -4;
}

int ug_ppm_write(const char* path, const uint8_t* data, int32_t w,
                 int32_t h) {
    FILE* fh = std::fopen(path, "wb");
    if (!fh) return -1;
    std::fprintf(fh, "P6\n%d %d\n255\n", w, h);
    size_t need = size_t(w) * h * 3;
    size_t got = std::fwrite(data, 1, need, fh);
    std::fclose(fh);
    return got == need ? 0 : -2;
}

// ---------------------------------------------------------------------
// Threaded file prefetcher (ring buffer of raw file bytes)
// ---------------------------------------------------------------------

struct UgPrefetcher {
    std::vector<std::string> paths;
    std::queue<std::pair<int64_t, std::vector<uint8_t>>> ready;
    std::mutex mu;
    std::condition_variable cv_ready, cv_space;
    size_t capacity;
    std::thread worker;
    std::atomic<bool> stop{false};
    std::atomic<bool> done{false};

    void run() {
        for (size_t i = 0; i < paths.size() && !stop.load(); ++i) {
            std::vector<uint8_t> data;
            FILE* fh = std::fopen(paths[i].c_str(), "rb");
            if (fh) {
                std::fseek(fh, 0, SEEK_END);
                long sz = std::ftell(fh);
                std::fseek(fh, 0, SEEK_SET);
                data.resize(sz > 0 ? sz : 0);
                if (sz > 0 &&
                    std::fread(data.data(), 1, sz, fh) != size_t(sz)) {
                    data.clear();
                }
                std::fclose(fh);
            }
            std::unique_lock<std::mutex> lk(mu);
            cv_space.wait(lk, [&] {
                return ready.size() < capacity || stop.load();
            });
            if (stop.load()) break;
            ready.emplace((int64_t)i, std::move(data));
            cv_ready.notify_one();
        }
        std::lock_guard<std::mutex> lk(mu);
        done.store(true);
        cv_ready.notify_all();
    }
};

void* ug_prefetcher_start(const char** paths, int64_t n_paths,
                          int64_t capacity) {
    auto* p = new UgPrefetcher();
    for (int64_t i = 0; i < n_paths; ++i) p->paths.emplace_back(paths[i]);
    p->capacity = size_t(capacity > 0 ? capacity : 2);
    p->worker = std::thread([p] { p->run(); });
    return p;
}

// Blocks until the next file is ready; returns its byte size (-1: done) and
// stores an index.  Call ug_prefetcher_copy to fetch the bytes.
int64_t ug_prefetcher_next_size(void* handle, int64_t* index) {
    auto* p = static_cast<UgPrefetcher*>(handle);
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_ready.wait(lk, [&] { return !p->ready.empty() || p->done.load(); });
    if (p->ready.empty()) return -1;
    *index = p->ready.front().first;
    return (int64_t)p->ready.front().second.size();
}

int64_t ug_prefetcher_copy(void* handle, uint8_t* out, int64_t cap) {
    auto* p = static_cast<UgPrefetcher*>(handle);
    std::unique_lock<std::mutex> lk(p->mu);
    if (p->ready.empty()) return -1;
    auto& front = p->ready.front().second;
    int64_t n = (int64_t)front.size();
    if (n > cap) return -2;
    std::memcpy(out, front.data(), n);
    p->ready.pop();
    p->cv_space.notify_one();
    return n;
}

void ug_prefetcher_stop(void* handle) {
    auto* p = static_cast<UgPrefetcher*>(handle);
    {
        // The store+notify must be serialized against the worker's
        // predicate check under mu: an unlocked notify can land in the
        // window between the worker evaluating (queue full, !stop) and
        // blocking, after which no wakeup ever comes and join() hangs.
        std::lock_guard<std::mutex> lk(p->mu);
        p->stop.store(true);
        p->cv_space.notify_all();
    }
    if (p->worker.joinable()) p->worker.join();
    delete p;
}

}  // extern "C"
