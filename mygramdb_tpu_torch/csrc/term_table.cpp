// Exact term table of mygramdb_tpu_torch: gram -> dense term id, the
// port's term dictionary (index/term_dict.py). A host library with a plain
// C ABI, bound through ctypes by native.py, which builds it with the host's
// C++ compiler into build/torch_host/ of the checkout.
//
// Every term's code points live in one arena (term t is
// arena[off[t], off[t+1])), so no host string or map entry exists per
// term. Slots are keyed by gram_hash, the shredder's hash, but a lookup
// compares code points too: two grams that share a hash get two ids. A
// gram of at most two code points below 2^21 (every Unicode gram of the
// usual sizes) is compared through its packed form, held in the slot;
// longer ones against the arena.
//
// mg_tt_resolve maps a batch of grams to ids in one call and numbers the
// batch's new grams itself: for the bulk build, the distinct ones in
// ascending hash order (code-point order on a shared hash) from the
// table's size, the order the builder has always used, so the built index
// is unchanged. Readers take the lock shared, writers exclusive.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <shared_mutex>
#include <utility>
#include <vector>

namespace {

// The shredder's gram hash (native/mygram_native.cpp, gram_hash): a
// batch's hashes come from the shredder, a single gram's from here, so
// the two must agree.
inline uint64_t gram_hash(const uint32_t* cp, int32_t size) {
  uint64_t h = 0x243F6A8885A308D3ULL ^ static_cast<uint64_t>(size);
  for (int32_t j = 0; j < size; ++j) {
    h ^= cp[j];
    h *= 0x9E3779B97F4A7C15ULL;
    h ^= h >> 29;
  }
  h ^= h >> 32;
  h *= 0xD6E8FEB86659FD93ULL;
  h ^= h >> 32;
  return h;
}

struct TermTable {
  struct Slot {
    uint64_t h;   // gram_hash
    uint64_t k;   // packed code points, or 0: compare against the arena
    int64_t id;   // -1 empty; <= -2: gram -id-2 pending in a bulk call
  };
  struct Pend {
    uint64_t h, k;
    const uint32_t* cp;
    int32_t len;
    size_t pos;  // its slot
  };
  std::vector<Slot> slots;
  std::vector<uint32_t> arena;
  std::vector<int64_t> off{0};
  size_t used = 0;
  mutable std::shared_mutex mu;

  TermTable() : slots(1 << 16, Slot{0, 0, -1}) {}

  int64_t size() const { return static_cast<int64_t>(off.size()) - 1; }

  static uint64_t pack(const uint32_t* cp, int32_t len) {
    if (len > 2) return 0;
    uint64_t k = (1ULL << 63) | (static_cast<uint64_t>(len) << 42);
    for (int32_t j = 0; j < len; ++j) {
      if (cp[j] >= (1u << 21)) return 0;
      k |= static_cast<uint64_t>(cp[j]) << (21 * (1 - j));
    }
    return k;
  }

  bool equal(const Slot& s, uint64_t k, const uint32_t* cp, int32_t len,
             const std::vector<Pend>* pend) const {
    if (k || s.k) return s.k == k;
    if (s.id >= 0) {
      const int64_t o = off[s.id];
      return off[s.id + 1] - o == len &&
             std::memcmp(arena.data() + o, cp, 4 * len) == 0;
    }
    const Pend& p = (*pend)[-s.id - 2];
    return p.len == len && std::memcmp(p.cp, cp, 4 * len) == 0;
  }

  // The slot holding the gram, or the empty slot where it goes; *clash is
  // set where a slot of the same hash and other code points was passed.
  size_t probe(uint64_t h, uint64_t k, const uint32_t* cp, int32_t len,
               const std::vector<Pend>* pend, bool* clash) const {
    const size_t mask = slots.size() - 1;
    size_t pos = static_cast<size_t>(h) & mask;
    for (;; pos = (pos + 1) & mask) {
      const Slot& s = slots[pos];
      if (s.id == -1) return pos;
      if (s.h != h) continue;
      if (equal(s, k, cp, len, pend)) return pos;
      *clash = true;
    }
  }

  // room for one more slot; a pending gram's slot moves with a rehash
  void reserve_one(std::vector<Pend>* pend = nullptr) {
    if ((used + 1) * 10 < slots.size() * 7) return;
    std::vector<Slot> old(slots.size() * 2, Slot{0, 0, -1});
    old.swap(slots);
    const size_t mask = slots.size() - 1;
    for (const Slot& s : old) {
      if (s.id == -1) continue;
      size_t pos = static_cast<size_t>(s.h) & mask;
      while (slots[pos].id != -1) pos = (pos + 1) & mask;
      slots[pos] = s;
      if (s.id <= -2) (*pend)[-s.id - 2].pos = pos;
    }
  }

  int64_t append(const uint32_t* cp, int32_t len) {
    arena.insert(arena.end(), cp, cp + len);
    off.push_back(static_cast<int64_t>(arena.size()));
    return size() - 1;
  }

  // get-or-add of one gram; a new gram takes the next id
  int64_t add_one(uint64_t h, const uint32_t* cp, int32_t len,
                  int64_t* collisions) {
    reserve_one();
    const uint64_t k = pack(cp, len);
    bool clash = false;
    const size_t pos = probe(h, k, cp, len, nullptr, &clash);
    if (slots[pos].id != -1) return slots[pos].id;
    *collisions += clash;
    slots[pos] = Slot{h, k, append(cp, len)};
    ++used;
    return slots[pos].id;
  }

  int64_t find(uint64_t h, const uint32_t* cp, int32_t len) const {
    bool clash = false;
    return slots[probe(h, pack(cp, len), cp, len, nullptr, &clash)].id;
  }
};

}  // namespace

extern "C" {

void* mg_tt_create(void) { return new TermTable(); }

void mg_tt_destroy(void* t) { delete static_cast<TermTable*>(t); }

int64_t mg_tt_size(void* t) {
  const TermTable* tt = static_cast<TermTable*>(t);
  std::shared_lock<std::shared_mutex> lk(tt->mu);
  return tt->size();
}

// One gram: its id, or -1 when absent and add == 0 (else it is added).
int64_t mg_tt_id(void* t, const uint32_t* cp, int32_t len, int32_t add) {
  TermTable* tt = static_cast<TermTable*>(t);
  const uint64_t h = gram_hash(cp, len);
  if (!add) {
    std::shared_lock<std::shared_mutex> lk(tt->mu);
    return tt->find(h, cp, len);
  }
  std::unique_lock<std::shared_mutex> lk(tt->mu);
  int64_t collisions = 0;
  return tt->add_one(h, cp, len, &collisions);
}

// A batch of grams, gram i being flat[starts[i], starts[i] + lens[i]),
// hashed by hashes[i] (gram_hash of it when hashes is null), to ids; a
// gram not in the table is added. New grams are numbered from the table's
// size: by (hash, code points) for the bulk build, or in input order where
// in_order is set, as get-or-add one by one would. Returns the new grams'
// count and adds to *collisions the new grams whose hash another gram
// already held.
int64_t mg_tt_resolve(void* t, const uint32_t* flat, const int32_t* starts,
                      const int32_t* lens, const uint64_t* hashes,
                      int64_t n, int32_t in_order, int32_t* out_ids,
                      int64_t* collisions) {
  TermTable* tt = static_cast<TermTable*>(t);
  auto hash_of = [&](int64_t i) {
    return hashes ? hashes[i] : gram_hash(flat + starts[i], lens[i]);
  };
  std::unique_lock<std::shared_mutex> lk(tt->mu);
  if (in_order) {
    const int64_t base = tt->size();
    for (int64_t i = 0; i < n; ++i)
      out_ids[i] = static_cast<int32_t>(
          tt->add_one(hash_of(i), flat + starts[i], lens[i], collisions));
    return tt->size() - base;
  }
  // pass 1: known grams take their ids; a new gram goes into the table as
  // pending (id -k-2), once however often the batch holds it
  std::vector<TermTable::Pend> pend;
  const int64_t ahead = 16;  // slots prefetched ahead of the probe
  for (int64_t i = 0; i < n; ++i) {
    tt->reserve_one(&pend);
    if (hashes && i + ahead < n)
      __builtin_prefetch(&tt->slots[static_cast<size_t>(hashes[i + ahead]) &
                                    (tt->slots.size() - 1)]);
    const uint64_t h = hash_of(i);
    const uint32_t* cp = flat + starts[i];
    const int32_t len = lens[i];
    const uint64_t k = TermTable::pack(cp, len);
    bool clash = false;
    const size_t pos = tt->probe(h, k, cp, len, &pend, &clash);
    TermTable::Slot& s = tt->slots[pos];
    if (s.id == -1) {
      *collisions += clash;
      s = TermTable::Slot{h, k, -static_cast<int64_t>(pend.size()) - 2};
      pend.push_back(TermTable::Pend{h, k, cp, len, pos});
      ++tt->used;
    }
    out_ids[i] = static_cast<int32_t>(s.id);
  }
  // pass 2: number the new grams by (hash, code points)
  const int64_t P = static_cast<int64_t>(pend.size());
  std::vector<std::pair<uint64_t, int64_t>> order(P);
  for (int64_t j = 0; j < P; ++j) order[j] = {pend[j].h, j};
  std::sort(order.begin(), order.end(), [&](const auto& a, const auto& b) {
    if (a.first != b.first) return a.first < b.first;
    const TermTable::Pend& x = pend[a.second];
    const TermTable::Pend& y = pend[b.second];
    return std::lexicographical_compare(x.cp, x.cp + x.len, y.cp,
                                        y.cp + y.len);
  });
  std::vector<int32_t> new_id(P);
  for (int64_t r = 0; r < P; ++r) {
    const TermTable::Pend& p = pend[order[r].second];
    new_id[order[r].second] = static_cast<int32_t>(tt->append(p.cp, p.len));
    tt->slots[p.pos].id = new_id[order[r].second];
  }
  // pass 3: the batch's pending ids become the new ids
  for (int64_t i = 0; i < n; ++i)
    if (out_ids[i] < 0) out_ids[i] = new_id[-out_ids[i] - 2];
  return P;
}

// Code points of terms [lo, hi): returns their count; when it is at most
// cap they are copied to out_cps, and out_off (hi - lo + 1 entries) gets
// each term's start in out_cps.
int64_t mg_tt_copy(void* t, int64_t lo, int64_t hi, uint32_t* out_cps,
                   int64_t cap, int64_t* out_off) {
  const TermTable* tt = static_cast<TermTable*>(t);
  std::shared_lock<std::shared_mutex> lk(tt->mu);
  const int64_t a = tt->off[lo];
  const int64_t count = tt->off[hi] - a;
  if (count > cap) return count;
  if (count) std::memcpy(out_cps, tt->arena.data() + a, 4 * count);
  for (int64_t j = lo; j <= hi; ++j) out_off[j - lo] = tt->off[j] - a;
  return count;
}

}  // extern "C"
