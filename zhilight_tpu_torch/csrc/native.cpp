// zhilight_tpu native runtime components (C ABI, loaded via ctypes).
//
// TPU-native equivalents of the reference's C++ host-side machinery:
//   * PageAllocator — ref-counted KV page pool + full-page prefix index with
//     LRU eviction (reference BlockAllocator/BlockTrieNode,
//     src/kvcache/block_allocator.h + PrefixCache, src/generator/prefix_cache.hpp).
//     This is the scheduler's per-step hot path: admission control, page
//     allocation for decode windows, prefix matching on every admit.
//   * calc_repetition_ngram — KMP failure-function ngram repetition penalty
//     (reference beam_util.cu:318-349), O(n) per step per penalized task.
//
// The Python package falls back to a pure-Python implementation when this
// library isn't built; tests assert behavioral parity between the two.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// hashing (FNV-1a chain over page-sized token chunks)
// ---------------------------------------------------------------------------
static uint64_t chunk_key(uint64_t prev, const int32_t* tokens, int n) {
    uint64_t h = prev ^ 0xcbf29ce484222325ULL;
    for (int i = 0; i < n; i++) {
        h ^= (uint64_t)(uint32_t)tokens[i];
        h *= 0x100000001b3ULL;
    }
    return h;
}

// ---------------------------------------------------------------------------
// PageAllocator
// ---------------------------------------------------------------------------
struct PageInfo {
    int32_t ref_count = 0;
    uint64_t key = 0;
    bool has_key = false;
    uint64_t lru_tick = 0;
};

struct PageAllocator {
    int32_t num_pages;
    int32_t page_size;
    bool enable_prefix;
    std::vector<int32_t> free_list;  // LIFO
    std::vector<PageInfo> info;
    std::unordered_map<uint64_t, int32_t> prefix_index;
    uint64_t tick = 0;
};

void* pa_create(int32_t num_pages, int32_t page_size, int32_t enable_prefix) {
    auto* pa = new PageAllocator();
    pa->num_pages = num_pages;
    pa->page_size = page_size;
    pa->enable_prefix = enable_prefix != 0;
    pa->info.resize(num_pages);
    pa->free_list.reserve(num_pages);
    for (int32_t p = num_pages - 1; p >= 0; p--) pa->free_list.push_back(p);
    return pa;
}

void pa_destroy(void* h) { delete static_cast<PageAllocator*>(h); }

static bool evict_one(PageAllocator* pa) {
    uint64_t best_tick = ~0ULL;
    uint64_t victim_key = 0;
    int32_t victim_page = -1;
    for (auto& kv : pa->prefix_index) {
        PageInfo& pi = pa->info[kv.second];
        if (pi.ref_count == 0 && pi.lru_tick < best_tick) {
            best_tick = pi.lru_tick;
            victim_key = kv.first;
            victim_page = kv.second;
        }
    }
    if (victim_page < 0) return false;
    pa->prefix_index.erase(victim_key);
    pa->info[victim_page] = PageInfo();
    pa->free_list.push_back(victim_page);
    return true;
}

int32_t pa_alloc(void* h) {
    auto* pa = static_cast<PageAllocator*>(h);
    if (pa->free_list.empty() && !evict_one(pa)) return -1;
    int32_t page = pa->free_list.back();
    pa->free_list.pop_back();
    pa->info[page] = PageInfo();
    pa->info[page].ref_count = 1;
    return page;
}

void pa_ref(void* h, int32_t page) {
    static_cast<PageAllocator*>(h)->info[page].ref_count++;
}

int32_t pa_free_page(void* h, int32_t page) {
    auto* pa = static_cast<PageAllocator*>(h);
    PageInfo& pi = pa->info[page];
    if (pi.ref_count <= 0) return -1;  // double free
    pi.ref_count--;
    if (pi.ref_count == 0) {
        if (pi.has_key && pa->enable_prefix) {
            pi.lru_tick = ++pa->tick;  // cached, evictable
        } else {
            pa->free_list.push_back(page);
            pa->info[page] = PageInfo();
        }
    }
    return 0;
}

int32_t pa_num_free(void* h) {
    auto* pa = static_cast<PageAllocator*>(h);
    int32_t n = (int32_t)pa->free_list.size();
    for (auto& kv : pa->prefix_index)
        if (pa->info[kv.second].ref_count == 0) n++;
    return n;
}

// Longest cached full-page prefix; increments refcounts of matched pages.
// Returns the number of pages written to out_pages.
int32_t pa_match_prefix(void* h, const int32_t* tokens, int32_t n, int32_t* out_pages,
                        int32_t cap) {
    auto* pa = static_cast<PageAllocator*>(h);
    if (!pa->enable_prefix) return 0;
    int32_t S = pa->page_size;
    // leave >= 1 token to prefill (reference reserves the last token)
    int32_t limit = n > 0 ? (n - 1) / S : 0;
    uint64_t key = 0;
    int32_t count = 0;
    for (int32_t i = 0; i < limit && count < cap; i++) {
        key = chunk_key(key, tokens + i * S, S);
        auto it = pa->prefix_index.find(key);
        if (it == pa->prefix_index.end()) break;
        PageInfo& pi = pa->info[it->second];
        pi.lru_tick = ++pa->tick;
        pi.ref_count++;
        out_pages[count++] = it->second;
    }
    return count;
}

void pa_register_prefix(void* h, const int32_t* tokens, int32_t n, const int32_t* pages,
                        int32_t npages) {
    auto* pa = static_cast<PageAllocator*>(h);
    if (!pa->enable_prefix) return;
    int32_t S = pa->page_size;
    uint64_t key = 0;
    int32_t full = n / S;
    for (int32_t i = 0; i < full && i < npages; i++) {
        key = chunk_key(key, tokens + i * S, S);
        auto it = pa->prefix_index.find(key);
        if (it == pa->prefix_index.end()) {
            PageInfo& pi = pa->info[pages[i]];
            if (!pi.has_key) {
                pi.has_key = true;
                pi.key = key;
                pa->prefix_index.emplace(key, pages[i]);
            }
        }
    }
}

int32_t pa_ref_count(void* h, int32_t page) {
    return static_cast<PageAllocator*>(h)->info[page].ref_count;
}

int32_t pa_num_cached(void* h) {
    return (int32_t)static_cast<PageAllocator*>(h)->prefix_index.size();
}

// ---------------------------------------------------------------------------
// ngram repetition penalty (reference beam_util.cu calc_repetition_ngram)
// ---------------------------------------------------------------------------
// tokens: the sequence (already reversed by the caller, like the reference).
// Writes up to cap (token, value) pairs; returns the pair count.
int32_t ngram_penalty(const int32_t* tokens, int32_t n, float p, float rep,
                      int32_t* out_tokens, float* out_vals, int32_t cap) {
    if (n <= 0) return 0;
    std::vector<int32_t> nxt(n);
    nxt[0] = -1;
    for (int32_t i = 0; i + 1 < n; i++) {
        int32_t q = nxt[i];
        while (q >= 0) {
            if (tokens[q + 1] == tokens[i + 1]) break;
            q = nxt[q];
        }
        nxt[i + 1] = (tokens[q + 1] == tokens[i + 1]) ? q + 1 : -1;
    }
    std::vector<int32_t> ngrams(n, 0);
    for (int32_t i = 0; i < n; i++) {
        int32_t ng = nxt[i] + 1;
        if (ngrams[i - ng] < ng) ngrams[i - ng] = ng;
    }
    std::unordered_map<int32_t, float> best;
    best.reserve(n * 2);
    for (int32_t i = 0; i < n; i++) {
        // v = p^(ngrams[i]+1)
        float v = 1.0f;
        for (int32_t e = 0; e <= ngrams[i]; e++) v *= p;
        auto it = best.find(tokens[i]);
        if (it == best.end() || v > it->second) best[tokens[i]] = v;
    }
    int32_t cnt = 0;
    for (auto& kv : best) {
        if (cnt >= cap) break;
        out_tokens[cnt] = kv.first;
        out_vals[cnt] = kv.second * rep;
        cnt++;
    }
    return cnt;
}

}  // extern "C"
