// melonix_tpu native runtime — host/control-plane hot paths.
//
// The reference implements its runtime in C++ (grain scan app.cpp:153-235,
// min/max pyramid app.cpp:347-426, LRU caches spec.cpp:18-42, the
// per-grain render walk app.cpp:294-345); this port keeps these host-side
// pieces native as well.  The *data plane* (FFTs, gather/lerp rendering,
// pitch analysis) lives on the accelerator — this library only does the
// sequential control-plane work that feeds it: chain selection, plan
// construction through the marker maps, cache bookkeeping, and lock-free
// audio streaming.
//
// Exposed as a plain C ABI consumed via ctypes (runtime/native.py).
// Build: make -C native

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <list>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Grain segmentation (semantics of app.cpp:153-235)
// ---------------------------------------------------------------------------

static inline bool is_zero_crossing(const float* wav, int64_t n, int64_t idx,
                                    int look) {
  if (idx < look) return false;
  if (idx >= n - look - 1) return false;
  for (int j = 0; j < look; ++j) {
    if (wav[idx - j] >= 0) return false;
    if (wav[idx + 1 + j] < 0) return false;
  }
  return true;
}

int64_t mlx_build_grains(const float* wav, int64_t n, int32_t pgs,
                         int32_t* out_starts, int32_t* out_lengths,
                         int64_t cap) {
  int64_t count = 0;
  if (n < pgs + 2) return 0;
  int64_t start = 0;
  while (start < n - pgs - 1) {
    bool found = false;
    // Primary: alternating +/- probes around start + pgs (app.cpp:163-193).
    for (int i = 0; i < pgs; ++i) {
      const int64_t idx = start + pgs + (i % 2 == 0 ? i / 2 : -(i / 2));
      if (is_zero_crossing(wav, n, idx, 7)) {
        if (count >= cap) return count;
        out_starts[count] = (int32_t)start;
        out_lengths[count] = (int32_t)(idx - start);
        ++count;
        start = idx;
        found = true;
        break;
      }
    }
    if (!found) {
      // Fallback: linear scan from 1.5x target (app.cpp:194-231).
      for (int64_t i = start + pgs + pgs / 2; i < n - 1; ++i) {
        if (is_zero_crossing(wav, n, i, 3)) {
          if (count >= cap) return count;
          out_starts[count] = (int32_t)start;
          out_lengths[count] = (int32_t)(i - start);
          ++count;
          start = i;
          found = true;
          break;
        }
      }
      if (!found) break;
    }
  }
  return count;
}

// ---------------------------------------------------------------------------
// Min/max pyramid (semantics of app.cpp:347-378): flattened level-major
// layout, level l holds n >> (l+1) entries.
// ---------------------------------------------------------------------------

int32_t mlx_calc_picks(const float* wav, int64_t n, float* mins, float* maxs,
                       int64_t cap) {
  if (n <= 2) return 0;
  int32_t levels = 0;
  int64_t off = 0;
  int64_t prev_off = 0;
  int64_t lvl_size = n / 2;
  // level 0 from raw pairs
  {
    if (off + lvl_size > cap) return -1;
    for (int64_t i = 0; i < lvl_size; ++i) {
      const float a = wav[2 * i], b = wav[2 * i + 1];
      mins[off + i] = a < b ? a : b;
      maxs[off + i] = a < b ? b : a;
    }
    ++levels;
  }
  int lvl = 1;
  while (n > (int64_t)1 << (lvl + 1)) {
    const int64_t sz = n >> (lvl + 1);
    const int64_t new_off = off + lvl_size;
    if (new_off + sz > cap) return -1;
    for (int64_t i = 0; i < sz; ++i) {
      const float mn1 = mins[off + 2 * i], mn2 = mins[off + 2 * i + 1];
      const float mx1 = maxs[off + 2 * i], mx2 = maxs[off + 2 * i + 1];
      mins[new_off + i] = mn1 < mn2 ? mn1 : mn2;
      maxs[new_off + i] = mx1 > mx2 ? mx1 : mx2;
    }
    prev_off = off;
    off = new_off;
    lvl_size = sz;
    ++levels;
    ++lvl;
  }
  (void)prev_off;
  return levels;
}

// Exact min/max over [start, end) using the flattened pyramid
// (bottom-up aligned decomposition; out-of-range contract of
// app.cpp:380-396).
void mlx_minmax_range(const float* wav, int64_t n, const float* mins,
                      const float* maxs, int32_t n_levels,
                      const int64_t* queries, int64_t n_queries,
                      float* out_min, float* out_max) {
  // Precompute level offsets.
  std::vector<int64_t> offs(n_levels + 1);
  offs[0] = 0;
  for (int l = 0; l < n_levels; ++l) offs[l + 1] = offs[l] + (n >> (l + 1));

  for (int64_t q = 0; q < n_queries; ++q) {
    int64_t s = queries[2 * q], e = queries[2 * q + 1];
    if (s >= e) {
      const float v = (s >= 0 && s < n) ? wav[s] : 0.f;
      out_min[q] = v;
      out_max[q] = v;
      continue;
    }
    if (s < 0 || e < 0 || s >= n || e >= n) {
      out_min[q] = 0.f;
      out_max[q] = 0.f;
      continue;
    }
    float mn = wav[s], mx = wav[s];
    int64_t lo = s, hi = e;
    int level = -1;  // -1 = raw samples
    while (lo < hi) {
      const float* vmin = level < 0 ? wav : mins + offs[level];
      const float* vmax = level < 0 ? wav : maxs + offs[level];
      const int64_t sz = level < 0 ? n : (n >> (level + 1));
      if (level >= n_levels) {
        // beyond stored levels: finish with raw remainder
        const int64_t scale = (int64_t)1 << (level + 1);
        for (int64_t i = lo * scale; i < hi * scale && i < n; ++i) {
          if (wav[i] < mn) mn = wav[i];
          if (wav[i] > mx) mx = wav[i];
        }
        break;
      }
      if ((lo & 1) && lo < sz) {
        if (vmin[lo] < mn) mn = vmin[lo];
        if (vmax[lo] > mx) mx = vmax[lo];
        ++lo;
      } else if (lo & 1) {
        ++lo;
      }
      if (lo < hi && (hi & 1) && (hi - 1) < sz) {
        if (vmin[hi - 1] < mn) mn = vmin[hi - 1];
        if (vmax[hi - 1] > mx) mx = vmax[hi - 1];
        --hi;
      } else if (lo < hi && (hi & 1)) {
        --hi;
      }
      lo >>= 1;
      hi >>= 1;
      ++level;
    }
    out_min[q] = mn;
    out_max[q] = mx;
  }
}

// ---------------------------------------------------------------------------
// Marker maps (double-precision semantics of app.cpp:1020-1122) and the
// render-plan builder (cursor chain of app.cpp:294-345 / 1194-1215).
// Knot arrays have length n_knots = n_markers + 1 with the origin at [0].
// ---------------------------------------------------------------------------

static double map_sample2time(const double* ks, const double* ts,
                              int64_t n_knots, double sr, double val) {
  if (val <= 0) return val / sr;
  for (int64_t i = 0; i + 1 < n_knots; ++i) {
    if (val > ks[i] && val <= ks[i + 1]) {
      return ts[i] + (val - ks[i]) * (ts[i + 1] - ts[i]) / (ks[i + 1] - ks[i]);
    }
  }
  return ts[n_knots - 1] + (val - ks[n_knots - 1]) / sr;
}

static int64_t map_time2sample(const double* ks, const double* ts,
                               int64_t n_knots, double sr, double val) {
  if (val <= 0) return (int64_t)(val * sr);
  for (int64_t i = 0; i + 1 < n_knots; ++i) {
    if (val > ts[i] && val <= ts[i + 1]) {
      return (int64_t)(ks[i] +
                       (val - ts[i]) * (ks[i + 1] - ks[i]) / (ts[i + 1] - ts[i]));
    }
  }
  return (int64_t)(ks[n_knots - 1] + (val - ts[n_knots - 1]) * sr);
}

static float map_time2bend(const double* ts, const double* bends,
                           int64_t n_knots, double duration, double val) {
  if (val <= 0) return 0.f;
  for (int64_t i = 0; i + 1 < n_knots; ++i) {
    if (val > ts[i] && val <= ts[i + 1]) {
      return (float)(bends[i] + (val - ts[i]) * (bends[i + 1] - bends[i]) /
                                    (ts[i + 1] - ts[i]));
    }
  }
  if (val > duration) return 0.f;
  const double pt = ts[n_knots - 1];
  const double pb = bends[n_knots - 1];
  return (float)(pb + (val - pt) * (0 - pb) / (duration - pt));
}

// First i >= 0 with floor((float)i * rate) >= length — float32 stepping
// parity with the device kernel and app.cpp:332-339.
static int64_t step_output_count(int32_t length, float rate) {
  const int64_t n0 = (int64_t)(length / (double)rate);
  for (int64_t i = n0 > 2 ? n0 - 2 : 0; i < n0 + 8; ++i) {
    if (std::floor((float)i * rate) >= (float)length) return i;
  }
  // Pathological; scan up.
  for (int64_t i = 0;; ++i) {
    if (std::floor((float)i * rate) >= (float)length) return i;
  }
}

// Builds the render plan.  Returns the number of steps; *tail_zeros is set
// to pgs when the chain exhausted the grain table (full-export mode).
int64_t mlx_build_plan(const int32_t* g_starts, const int32_t* g_lens,
                       int64_t n_grains, const double* ks, const double* ts,
                       const double* bends, int64_t n_knots, double sr,
                       double duration, double start_cursor, int64_t min_out,
                       int32_t pgs, int32_t* out_start, int32_t* out_len,
                       float* out_rate, int64_t* out_sz, int32_t* out_seam,
                       int64_t cap, int32_t* tail_zeros) {
  int64_t count = 0;
  int64_t total = 0;
  double cursor = start_cursor;
  *tail_zeros = 0;
  for (;;) {
    if (min_out >= 0 && total >= min_out) break;
    if (count >= cap) break;
    const float bend = map_time2bend(ts, bends, n_knots, duration, cursor);
    const float rate = powf(2.f, bend / 12.f);
    const int64_t sample = map_time2sample(ks, ts, n_knots, sr, cursor);
    // lower_bound over grain starts
    int64_t lo = 0, hi = n_grains;
    while (lo < hi) {
      const int64_t mid = (lo + hi) / 2;
      if ((int64_t)g_starts[mid] < sample)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo >= n_grains) {
      *tail_zeros = pgs;
      break;
    }
    const int32_t length = g_lens[lo];
    const int64_t sz = step_output_count(length, rate);
    const int64_t s2 =
        map_time2sample(ks, ts, n_knots, sr, cursor + (double)sz / sr);
    int64_t lo2 = 0, hi2 = n_grains;
    while (lo2 < hi2) {
      const int64_t mid = (lo2 + hi2) / 2;
      if ((int64_t)g_starts[mid] < s2)
        lo2 = mid + 1;
      else
        hi2 = mid;
    }
    out_start[count] = g_starts[lo];
    out_len[count] = length;
    out_rate[count] = rate;
    out_sz[count] = sz;
    out_seam[count] = lo2 < n_grains ? g_starts[lo2] : -1;
    ++count;
    total += sz;
    cursor += (double)sz / sr;
  }
  return count;
}

// ---------------------------------------------------------------------------
// LRU cache: int64 key -> int64 slot, capacity-bounded, front = newest.
// Mirrors the recency/eviction behavior of spec.cpp:18-42 (without the
// use-after-erase quirk noted in SURVEY.md).
// ---------------------------------------------------------------------------

struct MlxLru {
  int64_t capacity;
  std::list<int64_t> age;  // keys, front = most recent
  std::unordered_map<int64_t, std::pair<int64_t, std::list<int64_t>::iterator>>
      map;  // key -> (value, age iterator)
};

void* mlx_lru_new(int64_t capacity) { return new MlxLru{capacity, {}, {}}; }

void mlx_lru_free(void* h) { delete (MlxLru*)h; }

// Returns value or -1; touches recency.
int64_t mlx_lru_get(void* h, int64_t key) {
  auto* lru = (MlxLru*)h;
  auto it = lru->map.find(key);
  if (it == lru->map.end()) return -1;
  lru->age.erase(it->second.second);
  lru->age.push_front(key);
  it->second.second = lru->age.begin();
  return it->second.first;
}

// Inserts; if capacity exceeded evicts the oldest and returns its value
// through *evicted (key -> -1 if none).  Returns 0/1 = eviction happened.
int64_t mlx_lru_put(void* h, int64_t key, int64_t value, int64_t* evicted) {
  auto* lru = (MlxLru*)h;
  *evicted = -1;
  auto it = lru->map.find(key);
  if (it != lru->map.end()) {
    lru->age.erase(it->second.second);
    lru->age.push_front(key);
    it->second = {value, lru->age.begin()};
    return 0;
  }
  lru->age.push_front(key);
  lru->map.emplace(key, std::make_pair(value, lru->age.begin()));
  if ((int64_t)lru->map.size() > lru->capacity) {
    const int64_t oldest = lru->age.back();
    auto oit = lru->map.find(oldest);
    *evicted = oit->second.first;
    lru->map.erase(oit);
    lru->age.pop_back();
    return 1;
  }
  return 0;
}

int64_t mlx_lru_size(void* h) { return (int64_t)((MlxLru*)h)->map.size(); }

// ---------------------------------------------------------------------------
// SPSC float ring buffer for the audio callback path (the restWav backlog,
// app.cpp:274-291, without taking a lock on the audio thread).
// ---------------------------------------------------------------------------

struct MlxRing {
  std::vector<float> buf;
  std::atomic<int64_t> head{0};       // write index (producer-owned)
  std::atomic<int64_t> tail{0};       // read index (consumer-owned)
  std::atomic<int64_t> flush_req{0};  // bumped by mlx_ring_clear (any thread)
  int64_t flush_ack{0};               // consumer-thread local
};

// A flush (backlog drop on live edit) may be requested from the control
// thread while the consumer is mid-read; a direct tail store there would
// race with the consumer's own tail store and could be silently overwritten
// (stale pre-edit audio keeps playing).  Instead clear() only bumps an
// epoch; the CONSUMER applies it at its next read/avail, keeping every
// tail store on one thread — the SPSC contract stays intact.
static void mlx_ring_apply_flush(MlxRing* r) {
  const int64_t req = r->flush_req.load(std::memory_order_acquire);
  if (req != r->flush_ack) {
    r->tail.store(r->head.load(std::memory_order_acquire),
                  std::memory_order_release);
    r->flush_ack = req;
  }
}

void* mlx_ring_new(int64_t capacity) {
  auto* r = new MlxRing();
  r->buf.resize(capacity + 1);
  return r;
}

void mlx_ring_free(void* h) { delete (MlxRing*)h; }

int64_t mlx_ring_avail(void* h) {
  // Consumer-side (same thread as mlx_ring_read): applies pending flushes.
  auto* r = (MlxRing*)h;
  mlx_ring_apply_flush(r);
  const int64_t n = (int64_t)r->buf.size();
  return (r->head.load(std::memory_order_acquire) -
          r->tail.load(std::memory_order_acquire) + n) %
         n;
}

int64_t mlx_ring_write(void* h, const float* data, int64_t count) {
  auto* r = (MlxRing*)h;
  const int64_t n = (int64_t)r->buf.size();
  const int64_t head = r->head.load(std::memory_order_relaxed);
  const int64_t tail = r->tail.load(std::memory_order_acquire);
  const int64_t free_space = n - 1 - ((head - tail + n) % n);
  const int64_t todo = count < free_space ? count : free_space;
  for (int64_t i = 0; i < todo; ++i) r->buf[(head + i) % n] = data[i];
  r->head.store((head + todo) % n, std::memory_order_release);
  return todo;
}

int64_t mlx_ring_read(void* h, float* out, int64_t count) {
  auto* r = (MlxRing*)h;
  mlx_ring_apply_flush(r);
  const int64_t n = (int64_t)r->buf.size();
  const int64_t tail = r->tail.load(std::memory_order_relaxed);
  const int64_t head = r->head.load(std::memory_order_acquire);
  const int64_t avail = (head - tail + n) % n;
  const int64_t todo = count < avail ? count : avail;
  for (int64_t i = 0; i < todo; ++i) out[i] = r->buf[(tail + i) % n];
  r->tail.store((tail + todo) % n, std::memory_order_release);
  return todo;
}

void mlx_ring_clear(void* h) {
  // Safe from any thread: request-only; the consumer applies it (see
  // mlx_ring_apply_flush).  Equivalent to the reference's marker edits
  // under SDL_LockAudioDevice (app.cpp:935-941).
  auto* r = (MlxRing*)h;
  r->flush_req.fetch_add(1, std::memory_order_release);
}


}  // extern "C"

// ---------------------------------------------------------------------------
// WAV decoder (the native data loader; reference decodes via FFmpeg's C
// libav*/libswresample, app.cpp:624-741).  RIFF parse, PCM 8/16/24/32 and
// IEEE float32/64, optional mean downmix (libswresample's default matrix).
// Two-call protocol: mlx_wav_info sizes the caller's buffer, mlx_wav_read
// fills it.  Returns 0 on success, negative error codes on bad input.
// ---------------------------------------------------------------------------

#include <cstdio>

namespace {

struct WavFmt {
  uint16_t tag = 0;
  uint16_t channels = 0;
  uint32_t rate = 0;
  uint16_t bits = 0;
  long data_pos = -1;
  uint32_t data_size = 0;
};

static int wav_parse(FILE* f, WavFmt* w) {
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return -2;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0) return -2;
  unsigned char ch[8];
  while (fread(ch, 1, 8, f) == 8) {
    const uint32_t size = (uint32_t)ch[4] | ((uint32_t)ch[5] << 8) |
                          ((uint32_t)ch[6] << 16) | ((uint32_t)ch[7] << 24);
    if (memcmp(ch, "fmt ", 4) == 0) {
      unsigned char fmt[40] = {0};
      const uint32_t take = size < sizeof(fmt) ? size : (uint32_t)sizeof(fmt);
      if (take < 16) return -4;  // fmt chunk must carry the full PCM header
      if (fread(fmt, 1, take, f) != take) return -3;
      if (size > take && fseek(f, (long)(size - take), SEEK_CUR) != 0) return -3;
      w->tag = (uint16_t)(fmt[0] | (fmt[1] << 8));
      w->channels = (uint16_t)(fmt[2] | (fmt[3] << 8));
      w->rate = (uint32_t)fmt[4] | ((uint32_t)fmt[5] << 8) |
                ((uint32_t)fmt[6] << 16) | ((uint32_t)fmt[7] << 24);
      w->bits = (uint16_t)(fmt[14] | (fmt[15] << 8));
      if (w->tag == 0xFFFE && size >= 26)  // WAVE_FORMAT_EXTENSIBLE
        w->tag = (uint16_t)(fmt[24] | (fmt[25] << 8));
    } else if (memcmp(ch, "data", 4) == 0) {
      w->data_pos = ftell(f);
      w->data_size = size;
      if (fseek(f, (long)size, SEEK_CUR) != 0) break;
    } else {
      if (fseek(f, (long)size, SEEK_CUR) != 0) return -3;
    }
    if (size & 1) fseek(f, 1, SEEK_CUR);
  }
  if (w->data_pos < 0 || w->channels == 0 || w->bits == 0) return -4;
  if (w->channels > 1024) return -4;  // libsndfile's sanity cap: a
                                      // larger count is a corrupt header
  if (w->rate == 0 || w->rate > 0x7FFFFFFFu)
    return -4;  // rate crosses the int32 ABI; a wrapped-negative value
                // would poison every duration/time computation downstream
  // Clamp the declared size to the actual payload (the reference's own
  // writer over-reports by 16, save-wav.cpp:43).
  if (fseek(f, 0, SEEK_END) != 0) return -3;
  const long end = ftell(f);
  if (end - w->data_pos < (long)w->data_size)
    w->data_size = (uint32_t)(end - w->data_pos);
  // Only combinations mlx_wav_read can decode; everything else is an
  // explicit error instead of silent garbage/silence.
  const bool pcm_ok = w->tag == 1 && (w->bits == 8 || w->bits == 16 ||
                                      w->bits == 24 || w->bits == 32);
  const bool flt_ok = w->tag == 3 && (w->bits == 32 || w->bits == 64);
  if (!pcm_ok && !flt_ok) return -5;
  return 0;
}

}  // namespace

extern "C" int32_t mlx_wav_info(const char* path, int64_t* n_frames, int32_t* channels,
                     int32_t* rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavFmt w;
  const int rc = wav_parse(f, &w);
  fclose(f);
  if (rc != 0) return rc;
  const uint32_t frame_bytes = (uint32_t)w.channels * (w.bits / 8);
  if (frame_bytes == 0) return -4;
  *n_frames = (int64_t)(w.data_size / frame_bytes);
  *channels = w.channels;
  *rate = (int32_t)w.rate;
  return 0;
}

extern "C" int32_t mlx_wav_read(const char* path, float* out, int64_t n_frames,
                     int32_t mono) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavFmt w;
  int rc = wav_parse(f, &w);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  fseek(f, w.data_pos, SEEK_SET);
  const int ch = w.channels;
  const int bytes = w.bits / 8;
  std::vector<unsigned char> buf((size_t)(1 << 16) * ch * bytes);
  const int64_t frames_per_buf = (int64_t)(1 << 16);
  int64_t done = 0;
  const float inv_mean = mono ? 1.0f / (float)ch : 1.0f;
  while (done < n_frames) {
    const int64_t want = std::min(frames_per_buf, n_frames - done);
    const size_t got = fread(buf.data(), (size_t)ch * bytes, (size_t)want, f);
    if (got == 0) break;
    for (size_t i = 0; i < got; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < ch; ++c) {
        const unsigned char* p = buf.data() + (i * ch + c) * bytes;
        float v = 0.0f;
        switch (w.tag) {
          case 1:  // PCM
            if (w.bits == 16) {
              v = (float)(int16_t)(p[0] | (p[1] << 8)) / 32768.0f;
            } else if (w.bits == 8) {
              v = ((float)p[0] - 128.0f) / 128.0f;
            } else if (w.bits == 24) {
              int32_t s = (int32_t)p[0] | ((int32_t)p[1] << 8) |
                          ((int32_t)p[2] << 16);
              if (s >= (1 << 23)) s -= (1 << 24);
              v = (float)s / 8388608.0f;
            } else if (w.bits == 32) {
              int32_t s;
              memcpy(&s, p, 4);
              v = (float)s / 2147483648.0f;
            }
            break;
          case 3:  // IEEE float
            if (w.bits == 32) {
              memcpy(&v, p, 4);
            } else if (w.bits == 64) {
              double d;
              memcpy(&d, p, 8);
              v = (float)d;
            }
            break;
          default:
            fclose(f);
            return -5;
        }
        if (mono) {
          acc += v;
        } else {
          out[(done + (int64_t)i) * ch + c] = v;
        }
      }
      if (mono) out[done + (int64_t)i] = acc * inv_mean;
    }
    done += (int64_t)got;
  }
  fclose(f);
  return 0;
}

