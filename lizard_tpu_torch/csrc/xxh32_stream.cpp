// Streaming xxHash-32 on the host: the frame layer's content checksum over
// input that arrives in pieces (FrameEncoder.update, FrameDecoder.update).
// The state lives in a buffer the caller owns (ltt_xxh32_state_size bytes);
// the digest of any chunking equals the one-shot xxh32 of the whole input
// (lizard_tpu_torch/utils/xxh.py is the specification). Built with g++ by
// lizard_tpu_torch/runtime.py, plain C interface for ctypes; a host source,
// not a kernel.
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u,
                   P4 = 668265263u, P5 = 374761393u;

struct State {
  uint64_t total;    // bytes seen
  uint32_t v[4];     // lane accumulators
  uint32_t seed;
  uint32_t nbuf;     // bytes of a partial stripe in buf
  uint8_t buf[16];
};

inline uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline uint32_t read32(const uint8_t* p) {  // little-endian host
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t round32(uint32_t acc, uint32_t lane) {
  return rotl(acc + lane * P2, 13) * P1;
}

inline void stripe(State* s, const uint8_t* p) {
  s->v[0] = round32(s->v[0], read32(p));
  s->v[1] = round32(s->v[1], read32(p + 4));
  s->v[2] = round32(s->v[2], read32(p + 8));
  s->v[3] = round32(s->v[3], read32(p + 12));
}

}  // namespace

extern "C" {

int ltt_xxh32_state_size() { return static_cast<int>(sizeof(State)); }

void ltt_xxh32_reset(void* state, uint32_t seed) {
  State* s = static_cast<State*>(state);
  s->total = 0;
  s->seed = seed;
  s->nbuf = 0;
  s->v[0] = seed + P1 + P2;
  s->v[1] = seed + P2;
  s->v[2] = seed;
  s->v[3] = seed - P1;
}

void ltt_xxh32_update(void* state, const uint8_t* p, size_t n) {
  State* s = static_cast<State*>(state);
  s->total += n;
  if (s->nbuf) {                      // finish the partial stripe first
    size_t take = 16 - s->nbuf < n ? 16 - s->nbuf : n;
    std::memcpy(s->buf + s->nbuf, p, take);
    s->nbuf += static_cast<uint32_t>(take);
    p += take;
    n -= take;
    if (s->nbuf < 16) return;
    stripe(s, s->buf);
    s->nbuf = 0;
  }
  for (; n >= 16; p += 16, n -= 16) stripe(s, p);
  std::memcpy(s->buf, p, n);
  s->nbuf = static_cast<uint32_t>(n);
}

uint32_t ltt_xxh32_digest(const void* state) {
  const State* s = static_cast<const State*>(state);
  uint32_t h = s->total >= 16
                   ? rotl(s->v[0], 1) + rotl(s->v[1], 7) + rotl(s->v[2], 12) +
                         rotl(s->v[3], 18)
                   : s->seed + P5;
  h += static_cast<uint32_t>(s->total);
  const uint8_t* p = s->buf;
  uint32_t n = s->nbuf, i = 0;
  for (; i + 4 <= n; i += 4) h = rotl(h + read32(p + i) * P3, 17) * P4;
  for (; i < n; ++i) h = rotl(h + p[i] * P5, 11) * P1;
  h ^= h >> 15;
  h *= P2;
  h ^= h >> 13;
  h *= P3;
  h ^= h >> 16;
  return h;
}

}  // extern "C"
