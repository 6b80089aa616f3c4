// Radix page index: native backend for the KV prefix cache (the torch
// port's own copy of deepsearch_tts_tpu/native/radix_index.cpp).
//
// The serving scheduler matches every incoming prompt (hundreds of
// trajectories, multi-turn re-prefill each tool call) against the cached
// page tree. The Python tree hashes one tuple per page-sized chunk per
// level; this C++ index hashes raw int32 spans (FNV-1a) into per-node open
// hash maps, giving O(prompt_pages) matching with no Python-object traffic.
//
// C ABI (ctypes-friendly): all functions exported with extern "C"; the
// handle is an opaque pointer. Thread safety is the caller's job (the
// engine serializes scheduler access; Python holds the GIL around calls).
//
// No reference counterpart: the reference has zero native code and no
// prefix cache at all (SURVEY.md §2.2); its providers pay full prefill per
// turn.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct SpanKey {
    const int32_t* data;
    uint32_t len;
    uint64_t hash;
};

uint64_t fnv1a(const int32_t* d, uint32_t n) {
    uint64_t h = 1469598103934665603ull;
    const uint8_t* p = reinterpret_cast<const uint8_t*>(d);
    for (uint32_t i = 0; i < n * sizeof(int32_t); ++i) {
        h ^= p[i];
        h *= 1099511628211ull;
    }
    return h;
}

struct Node {
    // chunk content is owned by the node (copied on insert)
    std::vector<int32_t> chunk;
    int64_t page = -1;
    uint64_t last_used = 0;
    std::unordered_map<uint64_t, std::vector<Node*>> children;  // hash -> bucket

    ~Node() {
        for (auto& kv : children)
            for (Node* c : kv.second) delete c;
    }

    Node* find_child(const int32_t* d, uint32_t n, uint64_t h) {
        auto it = children.find(h);
        if (it == children.end()) return nullptr;
        for (Node* c : it->second)
            if (c->chunk.size() == n &&
                std::memcmp(c->chunk.data(), d, n * sizeof(int32_t)) == 0)
                return c;
        return nullptr;
    }
};

struct Index {
    Node root;
    uint32_t page_size;
    uint64_t clock = 0;
    uint64_t n_nodes = 0;
};

}  // namespace

extern "C" {

void* rpi_new(uint32_t page_size) {
    Index* ix = new Index();
    ix->page_size = page_size;
    return ix;
}

void rpi_free(void* h) { delete static_cast<Index*>(h); }

uint64_t rpi_size(void* h) { return static_cast<Index*>(h)->n_nodes; }

// Match the longest cached prefix of `tokens[0:n]` (whole pages only).
// Writes up to max_out page ids into out_pages; returns the match length in
// pages.
uint32_t rpi_match(void* h, const int32_t* tokens, uint32_t n,
                   int64_t* out_pages, uint32_t max_out) {
    Index* ix = static_cast<Index*>(h);
    const uint32_t ps = ix->page_size;
    Node* node = &ix->root;
    uint32_t out = 0;
    ix->clock++;
    for (uint32_t i = 0; i + ps <= n && out < max_out; i += ps) {
        uint64_t hash = fnv1a(tokens + i, ps);
        Node* child = node->find_child(tokens + i, ps, hash);
        if (child == nullptr || child->page < 0) break;
        child->last_used = ix->clock;
        out_pages[out++] = child->page;
        node = child;
    }
    return out;
}

// Insert a sequence's pages: pages[i] holds tokens [i*ps, (i+1)*ps).
// Returns how many NEW node references were created (caller bumps refcounts
// for exactly those pages; existing nodes are refreshed, not re-referenced).
// new_mask (len n_pages, may be null) gets 1 for newly inserted levels.
uint32_t rpi_insert(void* h, const int32_t* tokens, uint32_t n,
                    const int64_t* pages, uint32_t n_pages, uint8_t* new_mask) {
    Index* ix = static_cast<Index*>(h);
    const uint32_t ps = ix->page_size;
    Node* node = &ix->root;
    uint32_t created = 0;
    ix->clock++;
    for (uint32_t i = 0; i < n_pages && (i + 1) * ps <= n; ++i) {
        const int32_t* d = tokens + i * ps;
        uint64_t hash = fnv1a(d, ps);
        Node* child = node->find_child(d, ps, hash);
        if (child == nullptr) {
            child = new Node();
            child->chunk.assign(d, d + ps);
            child->page = pages[i];
            node->children[hash].push_back(child);
            ix->n_nodes++;
            created++;
            if (new_mask) new_mask[i] = 1;
        } else {
            if (new_mask) new_mask[i] = 0;
        }
        child->last_used = ix->clock;
        node = child;
    }
    return created;
}

// Evict the least-recently-used leaf; returns its page id, or -1 if empty.
int64_t rpi_evict_lru(void* h) {
    Index* ix = static_cast<Index*>(h);

    struct Best {
        Node* parent = nullptr;
        uint64_t hash = 0;
        Node* node = nullptr;
    } best;

    // iterative DFS
    std::vector<Node*> stack{&ix->root};
    std::vector<std::pair<Node*, uint64_t>> parents{{nullptr, 0}};
    while (!stack.empty()) {
        Node* cur = stack.back();
        stack.pop_back();
        auto par = parents.back();
        parents.pop_back();
        if (cur != &ix->root && cur->children.empty()) {
            if (best.node == nullptr || cur->last_used < best.node->last_used) {
                best.parent = par.first;
                best.hash = par.second;
                best.node = cur;
            }
        }
        for (auto& kv : cur->children)
            for (Node* c : kv.second) {
                stack.push_back(c);
                parents.push_back({cur, kv.first});
            }
    }
    if (best.node == nullptr) return -1;
    int64_t page = best.node->page;
    auto& bucket = best.parent->children[best.hash];
    for (size_t i = 0; i < bucket.size(); ++i)
        if (bucket[i] == best.node) {
            bucket.erase(bucket.begin() + i);
            break;
        }
    if (bucket.empty()) best.parent->children.erase(best.hash);
    delete best.node;
    ix->n_nodes--;
    return page;
}

}  // extern "C"
