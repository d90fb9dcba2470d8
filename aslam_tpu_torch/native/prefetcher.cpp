// Native dataset prefetch pipeline: worker threads decode RGB-D PNG pairs
// ahead of the consumer into a bounded in-order ring buffer.
//
// The decode pipeline is fully native: Python hands over the file lists once,
// then each aslam_prefetch_get() blocks only if the workers haven't
// reached that index yet.  No Python threads, no GIL involvement between
// frames — the consumer overlaps decode with device compute for free.
//
// C ABI (ctypes binding in aslam_tpu_torch/native/loader.py):
//   aslam_prefetch_create(rgb_paths, depth_paths, n, lookahead, workers)
//   aslam_prefetch_get(h, i, &rgb..., &depth...)   // in-order or random
//   aslam_prefetch_destroy(h)
//
// Build: python -m aslam_tpu_torch.native.build

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {
int aslam_decode_png(const char* path, int* out_w, int* out_h, int* out_c,
                     int* out_bits, void** out_buf);
void aslam_free(void* p);
}

namespace {

struct Image {
  void* buf = nullptr;
  int w = 0, h = 0, c = 0, bits = 0;
  int rc = -100;  // decode status; <0 and buf==nullptr when failed
};

struct Pair {
  Image rgb, depth;
  bool ready = false;
};

struct Prefetcher {
  std::vector<std::string> rgb_paths, depth_paths;
  int lookahead;

  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for slot i
  std::condition_variable cv_work;    // workers wait for window to advance
  std::unordered_map<int, Pair> slots;  // decoded, not yet consumed
  int next_to_schedule = 0;           // lowest index not yet claimed
  int consumer_pos = 0;               // lowest index not yet consumed
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv_work.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) t.join();
    for (auto& kv : slots) {
      if (kv.second.rgb.buf) aslam_free(kv.second.rgb.buf);
      if (kv.second.depth.buf) aslam_free(kv.second.depth.buf);
    }
  }

  void run_worker() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] {
          return stop.load() ||
                 (next_to_schedule < int(rgb_paths.size()) &&
                  next_to_schedule < consumer_pos + lookahead);
        });
        if (stop.load()) return;
        idx = next_to_schedule++;
        slots.emplace(idx, Pair{});  // claim the slot (not ready yet)
      }
      Pair p;
      p.rgb.rc = aslam_decode_png(rgb_paths[idx].c_str(), &p.rgb.w, &p.rgb.h,
                                  &p.rgb.c, &p.rgb.bits, &p.rgb.buf);
      p.depth.rc =
          aslam_decode_png(depth_paths[idx].c_str(), &p.depth.w, &p.depth.h,
                           &p.depth.c, &p.depth.bits, &p.depth.buf);
      p.ready = true;
      {
        std::lock_guard<std::mutex> lk(mu);
        slots[idx] = p;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Returns an opaque handle, or nullptr on bad arguments.  `paths` are
// NUL-separated concatenations of n strings each.
void* aslam_prefetch_create(const char* rgb_paths, const char* depth_paths,
                            int n, int lookahead, int workers) {
  if (n <= 0 || lookahead <= 0 || workers <= 0) return nullptr;
  auto* pf = new Prefetcher();
  const char* p = rgb_paths;
  for (int i = 0; i < n; i++) {
    pf->rgb_paths.emplace_back(p);
    p += pf->rgb_paths.back().size() + 1;
  }
  p = depth_paths;
  for (int i = 0; i < n; i++) {
    pf->depth_paths.emplace_back(p);
    p += pf->depth_paths.back().size() + 1;
  }
  pf->lookahead = lookahead;
  for (int i = 0; i < workers; i++) {
    pf->workers.emplace_back([pf] { pf->run_worker(); });
  }
  return pf;
}

// Fetch decoded pair `i`.  Blocks until workers produce it.  Indices may
// arrive out of order from the consumer; indices below an already-consumed
// position are re-decoded synchronously (random access fallback).  Returns
// 0 on success; both buffers are malloc'd and owned by the caller
// (free with aslam_free).
int aslam_prefetch_get(void* handle, int i, int* rw, int* rh, int* rc,
                       int* rbits, void** rbuf, int* dw, int* dh, int* dc,
                       int* dbits, void** dbuf) {
  auto* pf = static_cast<Prefetcher*>(handle);
  if (!pf || i < 0 || i >= int(pf->rgb_paths.size())) return -1;

  Pair p;
  bool from_ring = false;
  {
    std::unique_lock<std::mutex> lk(pf->mu);
    if (i >= pf->consumer_pos) {
      // advance the window so workers may claim up to i + lookahead
      pf->consumer_pos = i;
      pf->cv_work.notify_all();
      pf->cv_ready.wait(lk, [&] {
        auto it = pf->slots.find(i);
        return pf->stop.load() || (it != pf->slots.end() && it->second.ready);
      });
      if (pf->stop.load()) return -2;
      p = pf->slots[i];
      pf->slots.erase(i);
      pf->consumer_pos = i + 1;
      from_ring = true;
      // drop stale slots the consumer skipped past (seek forward)
      for (auto it = pf->slots.begin(); it != pf->slots.end();) {
        if (it->first < pf->consumer_pos && it->second.ready) {
          if (it->second.rgb.buf) aslam_free(it->second.rgb.buf);
          if (it->second.depth.buf) aslam_free(it->second.depth.buf);
          it = pf->slots.erase(it);
        } else {
          ++it;
        }
      }
      pf->cv_work.notify_all();
    }
  }
  if (!from_ring) {
    // behind the window: synchronous decode (rewind / replay access)
    p.rgb.rc = aslam_decode_png(pf->rgb_paths[i].c_str(), &p.rgb.w, &p.rgb.h,
                                &p.rgb.c, &p.rgb.bits, &p.rgb.buf);
    p.depth.rc =
        aslam_decode_png(pf->depth_paths[i].c_str(), &p.depth.w, &p.depth.h,
                         &p.depth.c, &p.depth.bits, &p.depth.buf);
  }
  if (p.rgb.rc != 0 || p.depth.rc != 0) {
    if (p.rgb.buf) aslam_free(p.rgb.buf);
    if (p.depth.buf) aslam_free(p.depth.buf);
    return -3;
  }
  *rw = p.rgb.w; *rh = p.rgb.h; *rc = p.rgb.c; *rbits = p.rgb.bits;
  *rbuf = p.rgb.buf;
  *dw = p.depth.w; *dh = p.depth.h; *dc = p.depth.c; *dbits = p.depth.bits;
  *dbuf = p.depth.buf;
  return 0;
}

void aslam_prefetch_destroy(void* handle) {
  delete static_cast<Prefetcher*>(handle);
}

}  // extern "C"
