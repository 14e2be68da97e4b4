// amr_native: native runtime components for audio_modem_radio.
//
// The reference implementation is pure Python (SURVEY.md §2: no native code
// of its own); this library is the rebuild's host-runtime muscle for the
// batch-decode path, where Python-level byte scanning and WAV parsing become
// the bottleneck once the device demodulates gigabytes per second:
//
//  * amr_scan_frames  — scan a demodulated byte stream for FBPC frames
//    (magic search + header sanity + CRC32 payload verification), returning
//    packed frame descriptors. Mirrors the accept/reject policy of
//    framing.parse_frames (and the reference parser, decoder.py:142-208).
//  * amr_load_wav_batch — load many 16-bit PCM mono/stereo WAV files into one
//    float32 sample matrix in parallel (one thread per file, capped), the
//    host-side feeder for decode_wav_batch.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread amr_native.cpp -o libamr_native.so -lz
// Exposed via ctypes (audio_modem_radio/native.py); plain C ABI.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// One parsed frame: offsets into the scanned buffer plus header fields.
struct FrameDesc {
  uint64_t name_off;
  uint32_t name_len;
  uint64_t payload_off;
  uint32_t payload_len;
  uint32_t part_number;
  uint32_t total_parts;
  uint32_t file_size;
  uint32_t file_crc;
  uint32_t crc_ok;  // 1 = payload CRC verified, 0 = damaged (header sane)
};

static inline uint32_t rd_u32le(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// Scan `buf[0..len)` for FBPC frames; write up to `max_out` descriptors.
// Returns the number of descriptors written (valid and damaged frames both;
// check crc_ok). Overlapping magic candidates are all tried, like the Python
// parser.
int64_t amr_scan_frames(const uint8_t* buf, uint64_t len, FrameDesc* out,
                        int64_t max_out) {
  static const uint8_t MAGIC[4] = {'F', 'B', 'P', 'C'};
  const uint64_t MAX_PAYLOAD = 50000000ull;
  int64_t n_out = 0;
  if (len < 34) return 0;
  const uint8_t* p = buf;
  const uint8_t* end = buf + len;
  while (n_out < max_out) {
    const uint8_t* hit =
        (const uint8_t*)memmem(p, (size_t)(end - p), MAGIC, 4);
    if (!hit) break;
    uint64_t start = (uint64_t)(hit - buf);
    p = hit + 1;  // next search continues one past this magic
    if (start + 30 > len) continue;
    uint32_t name_len = buf[start + 4];
    if (name_len == 0) continue;
    uint64_t meta = start + 5 + name_len;
    if (meta + 24 > len) continue;
    uint32_t part = rd_u32le(buf + meta);
    uint32_t total = rd_u32le(buf + meta + 4);
    uint32_t fsize = rd_u32le(buf + meta + 8);
    uint32_t fcrc = rd_u32le(buf + meta + 12);
    uint32_t dlen = rd_u32le(buf + meta + 16);
    uint32_t pcrc = rd_u32le(buf + meta + 20);
    if (dlen == 0 || dlen > MAX_PAYLOAD) continue;
    uint64_t payload = meta + 24;
    if (payload + dlen > len) continue;
    if (total == 0 || total > 16384u || part >= total) continue;  // MAX_PARTS, framing.py
    uint32_t crc = (uint32_t)crc32(0L, buf + payload, dlen);
    FrameDesc& d = out[n_out++];
    d.name_off = start + 5;
    d.name_len = name_len;
    d.payload_off = payload;
    d.payload_len = dlen;
    d.part_number = part;
    d.total_parts = total;
    d.file_size = fsize;
    d.file_crc = fcrc;
    d.crc_ok = (crc == pcrc) ? 1u : 0u;
  }
  return n_out;
}

// ---------------------------------------------------------------------------
// WAV batch loader: 8/16/32-bit PCM or 32-bit float, mono-ized (channel 0),
// written into row i of `out` (row_len floats, zero-padded / truncated).
// Returns per-file sample rate in `rates[i]` (0 on failure).

struct WavJob {
  const char* path;
  float* row;
  uint64_t row_len;
  int32_t* rate;
  int64_t* n_samples;
};

// Find the shortest prefix of buf[0..len) whose CRC32 equals `target`.
// Returns the prefix length, or 0 if no prefix matches. Used by the
// header-tolerant frame recovery: a frame's corrupt `dlen` field is
// recoverable exactly when the payload CRC field survived — the payload is
// the unique span prefix matching it. The Python per-byte loop costs
// ~0.3 us/byte; this is the same incremental scan at zlib speed.
int64_t amr_crc32_prefix_find(const uint8_t* buf, uint64_t len,
                              uint32_t target) {
  uLong crc = crc32(0L, Z_NULL, 0);
  for (uint64_t i = 0; i < len; ++i) {
    crc = crc32(crc, buf + i, 1);
    if ((uint32_t)crc == target) return (int64_t)(i + 1);
  }
  return 0;
}

static void load_one_wav(const WavJob& job) {
  *job.rate = 0;
  *job.n_samples = 0;
  FILE* f = fopen(job.path, "rb");
  if (!f) return;
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) ||
      memcmp(hdr + 8, "WAVE", 4)) {
    fclose(f);
    return;
  }
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  bool have_fmt = false;
  // Chunk walk.
  for (;;) {
    uint8_t ch[8];
    if (fread(ch, 1, 8, f) != 8) break;
    uint32_t csz = rd_u32le(ch + 4);
    if (!memcmp(ch, "fmt ", 4)) {
      uint8_t fbuf[16];
      if (csz < 16 || fread(fbuf, 1, 16, f) != 16) break;
      fmt = (uint16_t)(fbuf[0] | (fbuf[1] << 8));
      channels = (uint16_t)(fbuf[2] | (fbuf[3] << 8));
      rate = rd_u32le(fbuf + 4);
      bits = (uint16_t)(fbuf[14] | (fbuf[15] << 8));
      have_fmt = true;
      if (csz > 16) fseek(f, (long)(csz - 16), SEEK_CUR);
    } else if (!memcmp(ch, "data", 4)) {
      if (!have_fmt || channels == 0) break;
      uint32_t bytes_per = (uint32_t)(bits / 8) * channels;
      if (bytes_per == 0) break;
      uint64_t frames = csz / bytes_per;
      uint64_t n = frames < job.row_len ? frames : job.row_len;
      std::vector<uint8_t> raw((size_t)n * bytes_per);
      if (fread(raw.data(), 1, raw.size(), f) != raw.size()) break;
      const uint8_t* src = raw.data();
      for (uint64_t i = 0; i < n; i++, src += bytes_per) {
        float v = 0.f;
        if (bits == 16) {
          int16_t s;
          memcpy(&s, src, 2);
          v = (float)s / 32768.f;
        } else if (bits == 32 && fmt == 3) {
          memcpy(&v, src, 4);
        } else if (bits == 32) {
          int32_t s;
          memcpy(&s, src, 4);
          v = (float)s / 2147483648.f;
        } else if (bits == 8) {
          v = ((float)src[0] - 128.f) / 128.f;
        }
        job.row[i] = v;
      }
      *job.rate = (int32_t)rate;
      *job.n_samples = (int64_t)n;
      break;
    } else {
      fseek(f, (long)csz + (csz & 1), SEEK_CUR);
    }
  }
  fclose(f);
}

// Load `n_files` WAVs in parallel into `out` (n_files x row_len floats,
// caller-zeroed). paths: array of NUL-terminated strings.
void amr_load_wav_batch(const char** paths, int64_t n_files, float* out,
                        uint64_t row_len, int32_t* rates, int64_t* n_samples,
                        int32_t max_threads) {
  std::atomic<int64_t> next(0);
  int nthreads = (int)std::min<int64_t>(
      n_files, max_threads > 0 ? max_threads
                               : (int32_t)std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_files) return;
      WavJob job{paths[i], out + (uint64_t)i * row_len, row_len, rates + i,
                 n_samples + i};
      load_one_wav(job);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// Viterbi decoder for the K=7, rate-1/2 code (G1=0o171, G2=0o133) — the ACS
// inner loop of fec.ViterbiDecoder. The 64-state trellis is a terrible fit
// for an accelerator (a 9216-step lax.scan over 64-lane vectors leaves the
// matrix units idle; a 512 KB guessed span once measured 259 s through the block-parallel
// JAX path — decoder.py header-recovery cap), while one scalar C++ sweep
// sustains >1 Mbit/s/core: header-tolerant recovery can afford multi-MB
// candidate spans (decoder._MAX_FEC_VALIDATE rises 512 KB -> 4 MB when this
// symbol is available).
//
// Semantics mirror fec._viterbi_block exactly: L1 branch metric against the
// expected {0,1} output pairs (soft inputs in [0,1] welcome), ties keep the
// p0 = s>>1 predecessor (JAX: choose1 = cand1 < cand0, strict), traceback
// from state 0 with `known_boundaries`, else from the best end state.
// Metrics accumulate in double (T can reach 2^24 steps; float32 would lose
// the +1-per-step increments past 2^24 — the reason the JAX path
// re-normalizes every step).

static inline uint8_t parity7(uint32_t x) {
  x &= 0x7f;
  x ^= x >> 4;
  x ^= x >> 2;
  x ^= x >> 1;
  return (uint8_t)(x & 1);
}

// Decode (T, 2) float pairs -> T bits. decisions: one uint64 bitmask per
// step (bit s set = state s took the p1 = (s>>1)|32 predecessor).
// Returns 0 on success, -1 on allocation failure.
int64_t amr_viterbi_decode(const float* pairs, int64_t T,
                           int32_t known_boundaries, uint8_t* bits_out) {
  static const uint32_t G1 = 0171, G2 = 0133;  // octal, as in fec.py
  const int NS = 64;
  // Only 4 distinct expected output pairs exist; per (new state, predecessor
  // choice) store the 2-bit code into a per-step 4-entry metric table.
  uint8_t c0tab[NS], c1tab[NS];
  for (int s = 0; s < NS; s++) {
    uint32_t b = (uint32_t)s & 1u;
    uint32_t p0 = (uint32_t)s >> 1;
    uint32_t p1 = p0 | 32u;
    uint32_t reg0 = (p0 << 1) | b;
    uint32_t reg1 = (p1 << 1) | b;
    c0tab[s] = (uint8_t)((parity7(reg0 & G1) << 1) | parity7(reg0 & G2));
    c1tab[s] = (uint8_t)((parity7(reg1 & G1) << 1) | parity7(reg1 & G2));
  }
  uint64_t* decisions = (uint64_t*)malloc((size_t)T * sizeof(uint64_t));
  if (!decisions && T > 0) return -1;

  const double BIG = 1e12;
  double pm[NS], pm_new[NS];
  for (int s = 0; s < NS; s++) pm[s] = known_boundaries ? BIG : 0.0;
  if (known_boundaries) pm[0] = 0.0;

  for (int64_t t = 0; t < T; t++) {
    const double r0 = (double)pairs[2 * t];
    const double r1 = (double)pairs[2 * t + 1];
    const double a0 = r0 > 0.0 ? r0 : -r0;        // |r - 0|
    const double a1 = r0 > 1.0 ? r0 - 1.0 : 1.0 - r0;  // |r - 1|
    const double b0 = r1 > 0.0 ? r1 : -r1;
    const double b1 = r1 > 1.0 ? r1 - 1.0 : 1.0 - r1;
    const double m[4] = {a0 + b0, a0 + b1, a1 + b0, a1 + b1};
    uint64_t dec = 0;
    for (int s = 0; s < NS; s++) {
      const double c0 = pm[s >> 1] + m[c0tab[s]];
      const double c1 = pm[(s >> 1) | 32] + m[c1tab[s]];
      const int choose1 = c1 < c0;
      pm_new[s] = choose1 ? c1 : c0;
      dec |= (uint64_t)choose1 << s;
    }
    decisions[t] = dec;
    memcpy(pm, pm_new, sizeof(pm));
  }

  int state = 0;
  if (!known_boundaries) {
    double best = pm[0];
    for (int s = 1; s < NS; s++)
      if (pm[s] < best) { best = pm[s]; state = s; }
  }
  for (int64_t t = T - 1; t >= 0; t--) {
    bits_out[t] = (uint8_t)(state & 1);
    const int ch = (int)((decisions[t] >> state) & 1u);
    state = ch ? ((state >> 1) | 32) : (state >> 1);
  }
  free(decisions);
  return 0;
}

}  // extern "C"
