// Native WGL / just-in-time-linearization search over int-encoded event
// streams: the host rung of the linearizability checker (`native-c`) and
// the CPU lane of the key-batched check. The same algorithm as
// checker/linear_cpu.py::check_stream (Lowe-style lazy closure before each
// return event), compiled C++ with an open-addressing flat hash set
// instead of Python sets.
//
// Copied from jepsen_tpu/native/wgl.cpp (whole file; only this comment
// differs). Built with g++ at first use by jepsen_tpu_torch.native.
//
// C ABI:
//   int wgl_check(const int8_t* kind, const int32_t* slot,
//                 const int32_t* f, const int32_t* a, const int32_t* b,
//                 int64_t n_events, int32_t init_state, int32_t model_id,
//                 int64_t max_configs, int64_t out_stats[3]);
// returns 1 valid, 0 invalid, -1 capacity exceeded (unknown),
// -2 unsupported input. out_stats = {died_event, peak_configs, explored}.
// model_id 0 = cas-register family (read/write/cas; read of id 0 matches
// any state — matches models.cas_register_spec).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int8_t EV_INVOKE = 0;
constexpr int8_t EV_RETURN = 1;
// EV_NOOP = 2

constexpr int32_t F_READ = 0;
constexpr int32_t F_WRITE = 1;
constexpr int32_t F_CAS = 2;

// A config packs (mask:64, state:32) into one 128-bit key.
using Key = unsigned __int128;

inline Key make_key(uint64_t mask, int32_t state) {
  return (Key(mask) << 32) | uint32_t(state);
}
inline uint64_t key_mask(Key k) { return uint64_t(k >> 32); }
inline int32_t key_state(Key k) { return int32_t(uint32_t(k)); }

inline uint64_t mix(uint64_t x) {  // splitmix64 finalizer
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}
inline uint64_t hash_key(Key k) {
  return mix(uint64_t(k)) ^ mix(uint64_t(k >> 64) * 0x100000001b3ULL);
}

// Open-addressing set of Keys. EMPTY sentinel = all-ones (mask of all 64
// slots with state -1 cannot occur: masks are limited to n_slots<=63 bits).
class FlatSet {
 public:
  explicit FlatSet(size_t initial_pow2 = 1 << 12)
      : slots_(initial_pow2, kEmpty), count_(0) {}

  // returns true if inserted (was absent)
  bool insert(Key k) {
    if ((count_ + 1) * 4 >= slots_.size() * 3) grow();
    size_t m = slots_.size() - 1;
    size_t i = hash_key(k) & m;
    while (true) {
      Key cur = slots_[i];
      if (cur == kEmpty) {
        slots_[i] = k;
        ++count_;
        return true;
      }
      if (cur == k) return false;
      i = (i + 1) & m;
    }
  }

  size_t size() const { return count_; }

  template <typename Fn>
  void for_each(Fn fn) const {
    for (Key k : slots_)
      if (k != kEmpty) fn(k);
  }

 private:
  static constexpr Key kEmpty = ~Key(0);

  void grow() {
    std::vector<Key> old;
    old.swap(slots_);
    slots_.assign(old.size() * 2, kEmpty);
    size_t m = slots_.size() - 1;
    for (Key k : old) {
      if (k == kEmpty) continue;
      size_t i = hash_key(k) & m;
      while (slots_[i] != kEmpty) i = (i + 1) & m;
      slots_[i] = k;
    }
  }

  std::vector<Key> slots_;
  size_t count_;
};

// cas-register transition; returns ok, writes new state.
inline bool step_cas(int32_t state, int32_t f, int32_t a, int32_t b,
                     int32_t* out) {
  switch (f) {
    case F_READ:
      *out = state;
      return a == 0 || a == state;
    case F_WRITE:
      *out = a;
      return true;
    case F_CAS:
      *out = b;
      return state == a;
    default:
      return false;
  }
}

}  // namespace

extern "C" int wgl_check(const int8_t* kind, const int32_t* slot,
                         const int32_t* f, const int32_t* a, const int32_t* b,
                         int64_t n_events, int32_t init_state,
                         int32_t model_id, int64_t max_configs,
                         int64_t* out_stats) {
  out_stats[0] = -1;  // died_event
  out_stats[1] = 1;   // peak_configs
  out_stats[2] = 0;   // explored
  if (model_id != 0) return -2;
  if (max_configs <= 0) max_configs = 20'000'000;

  // slot bound check (we pack masks into 63 bits; sentinel uses the rest)
  int32_t max_slot = -1;
  for (int64_t e = 0; e < n_events; ++e)
    if (kind[e] == EV_INVOKE && slot[e] > max_slot) max_slot = slot[e];
  if (max_slot >= 63) return -2;

  struct Op {
    int32_t f, a, b;
  };
  std::vector<Op> cur(size_t(max_slot < 0 ? 1 : max_slot + 1));

  std::vector<Key> configs{make_key(0, init_state)};
  uint64_t pending = 0;
  int64_t explored = 1;
  int64_t peak = 1;

  for (int64_t e = 0; e < n_events; ++e) {
    int8_t k = kind[e];
    if (k == EV_INVOKE) {
      int32_t s = slot[e];
      cur[size_t(s)] = {f[e], a[e], b[e]};
      pending |= 1ULL << s;
      continue;
    }
    if (k != EV_RETURN) continue;
    int32_t s = slot[e];
    uint64_t bit = 1ULL << s;

    // closure under linearizing any pending, unlinearized op
    FlatSet seen;
    for (Key c : configs) seen.insert(c);
    std::vector<Key> frontier = configs;
    std::vector<Key> next;
    while (!frontier.empty()) {
      next.clear();
      for (Key c : frontier) {
        uint64_t mask = key_mask(c);
        int32_t state = key_state(c);
        uint64_t avail = pending & ~mask;
        while (avail) {
          uint64_t low = avail & (~avail + 1);
          avail ^= low;
          int sl = __builtin_ctzll(low);
          const Op& op = cur[size_t(sl)];
          int32_t st2;
          if (step_cas(state, op.f, op.a, op.b, &st2)) {
            Key c2 = make_key(mask | low, st2);
            if (seen.insert(c2)) next.push_back(c2);
          }
        }
      }
      frontier.swap(next);
      if (int64_t(seen.size()) > max_configs) {
        out_stats[1] = peak;
        out_stats[2] = explored + int64_t(seen.size());
        return -1;
      }
    }
    explored += int64_t(seen.size());
    if (int64_t(seen.size()) > peak) peak = int64_t(seen.size());

    // keep configs that linearized op s; free its slot bit
    FlatSet dedup;
    std::vector<Key> survivors;
    seen.for_each([&](Key c) {
      uint64_t mask = key_mask(c);
      if (mask & bit) {
        Key c2 = make_key(mask & ~bit, key_state(c));
        if (dedup.insert(c2)) survivors.push_back(c2);
      }
    });
    pending &= ~bit;
    configs.swap(survivors);
    if (configs.empty()) {
      out_stats[0] = e;
      out_stats[1] = peak;
      out_stats[2] = explored;
      return 0;
    }
  }
  out_stats[1] = peak;
  out_stats[2] = explored;
  return 1;
}
