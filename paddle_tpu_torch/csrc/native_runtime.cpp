// Native runtime core: bounded byte-queue for data prefetch + host arena.
//
// Reference roles: paddle/fluid/memory/ (allocators) and the C++ side of the
// reader/DataLoader pipeline (paddle/fluid/operators/reader/ buffered readers,
// blocking_queue.h — behavior studied, code re-designed). TPU-first: the host
// side only needs to (a) keep the input pipeline ahead of the device without
// holding the GIL during copies, and (b) reuse pinned-ish staging buffers so
// numpy batch assembly doesn't thrash the allocator. ctypes releases the GIL
// around every call into this library, so producer/consumer memcpys and
// blocking waits overlap Python-side work.
//
// Build: cc -O3 -shared -fPIC native_runtime.cpp -o libpaddle_tpu_native.so
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Bounded blocking byte queue (multi-producer, multi-consumer)
// ---------------------------------------------------------------------------

struct ByteQueue {
    std::mutex mu;
    std::condition_variable not_full;
    std::condition_variable not_empty;
    std::deque<std::vector<uint8_t>> items;
    size_t capacity_items;
    size_t capacity_bytes;
    size_t bytes = 0;
    bool closed = false;
};

void* ptq_create(size_t capacity_items, size_t capacity_bytes) {
    auto* q = new ByteQueue();
    q->capacity_items = capacity_items ? capacity_items : 1;
    q->capacity_bytes = capacity_bytes ? capacity_bytes : (size_t)1 << 62;
    return q;
}

// Returns 0 on success, -1 if queue closed.
int ptq_push(void* handle, const uint8_t* data, size_t nbytes) {
    auto* q = static_cast<ByteQueue*>(handle);
    std::unique_lock<std::mutex> lk(q->mu);
    q->not_full.wait(lk, [&] {
        return q->closed || (q->items.size() < q->capacity_items &&
                             q->bytes + nbytes <= q->capacity_bytes) ||
               q->items.empty();  // oversized item allowed when queue empty
    });
    if (q->closed) return -1;
    q->items.emplace_back(data, data + nbytes);
    q->bytes += nbytes;
    q->not_empty.notify_one();
    return 0;
}

// Push with a 1-byte frame tag prepended — saves the caller assembling a
// tag+payload copy in Python (the memcpy out of shared memory happens here,
// with the GIL already released by ctypes).
int ptq_push_tagged(void* handle, uint8_t tag, const uint8_t* data,
                    size_t nbytes) {
    auto* q = static_cast<ByteQueue*>(handle);
    std::unique_lock<std::mutex> lk(q->mu);
    q->not_full.wait(lk, [&] {
        return q->closed || (q->items.size() < q->capacity_items &&
                             q->bytes + nbytes + 1 <= q->capacity_bytes) ||
               q->items.empty();
    });
    if (q->closed) return -1;
    std::vector<uint8_t> item(nbytes + 1);
    item[0] = tag;
    std::memcpy(item.data() + 1, data, nbytes);
    q->items.emplace_back(std::move(item));
    q->bytes += nbytes + 1;
    q->not_empty.notify_one();
    return 0;
}

// Returns size of the popped item (>=0), -1 when closed+drained.
// The item is copied into out (caller sizes it via ptq_peek_size).
int64_t ptq_peek_size(void* handle) {
    auto* q = static_cast<ByteQueue*>(handle);
    std::unique_lock<std::mutex> lk(q->mu);
    q->not_empty.wait(lk, [&] { return q->closed || !q->items.empty(); });
    if (q->items.empty()) return -1;
    return (int64_t)q->items.front().size();
}

int64_t ptq_pop(void* handle, uint8_t* out, size_t out_cap) {
    auto* q = static_cast<ByteQueue*>(handle);
    std::unique_lock<std::mutex> lk(q->mu);
    q->not_empty.wait(lk, [&] { return q->closed || !q->items.empty(); });
    if (q->items.empty()) return -1;
    auto& front = q->items.front();
    size_t n = front.size();
    if (n > out_cap) return -2;  // caller must re-size via ptq_peek_size
    std::memcpy(out, front.data(), n);
    q->bytes -= n;
    q->items.pop_front();
    q->not_full.notify_one();
    return (int64_t)n;
}

// Timed variant: waits up to timeout_ms for an item. Returns item size
// (>=0) on success, -1 closed+drained, -2 out too small, -3 timed out.
int64_t ptq_pop_timed(void* handle, uint8_t* out, size_t out_cap,
                      int64_t timeout_ms) {
    auto* q = static_cast<ByteQueue*>(handle);
    std::unique_lock<std::mutex> lk(q->mu);
    bool ok = q->not_empty.wait_for(
        lk, std::chrono::milliseconds(timeout_ms),
        [&] { return q->closed || !q->items.empty(); });
    if (!ok) return -3;
    if (q->items.empty()) return -1;
    auto& front = q->items.front();
    size_t n = front.size();
    if (n > out_cap) return -2;
    std::memcpy(out, front.data(), n);
    q->bytes -= n;
    q->items.pop_front();
    q->not_full.notify_one();
    return (int64_t)n;
}

int64_t ptq_size(void* handle) {
    auto* q = static_cast<ByteQueue*>(handle);
    std::lock_guard<std::mutex> lk(q->mu);
    return (int64_t)q->items.size();
}

void ptq_close(void* handle) {
    auto* q = static_cast<ByteQueue*>(handle);
    std::lock_guard<std::mutex> lk(q->mu);
    q->closed = true;
    q->not_empty.notify_all();
    q->not_full.notify_all();
}

void ptq_destroy(void* handle) {
    delete static_cast<ByteQueue*>(handle);
}

// ---------------------------------------------------------------------------
// Host staging arena: size-bucketed freelist allocator
// (reference role: paddle/fluid/memory BestFit/auto-growth allocators)
// ---------------------------------------------------------------------------

struct Arena {
    std::mutex mu;
    // bucket (log2-rounded size) -> freelist of blocks
    std::unordered_map<size_t, std::vector<void*>> freelists;
    std::unordered_map<void*, size_t> live;  // ptr -> bucket size
    std::atomic<size_t> total_reserved{0};
    size_t limit_bytes;
};

static size_t round_bucket(size_t n) {
    size_t b = 256;
    while (b < n) b <<= 1;
    return b;
}

void* arena_create(size_t limit_bytes) {
    auto* a = new Arena();
    a->limit_bytes = limit_bytes ? limit_bytes : (size_t)4 << 30;
    return a;
}

void* arena_alloc(void* handle, size_t nbytes) {
    auto* a = static_cast<Arena*>(handle);
    size_t bucket = round_bucket(nbytes);
    {
        std::lock_guard<std::mutex> lk(a->mu);
        auto it = a->freelists.find(bucket);
        if (it != a->freelists.end() && !it->second.empty()) {
            void* p = it->second.back();
            it->second.pop_back();
            a->live[p] = bucket;
            return p;
        }
    }
    if (a->total_reserved.load() + bucket > a->limit_bytes) {
        // reclaim: drop all cached blocks
        std::lock_guard<std::mutex> lk(a->mu);
        for (auto& kv : a->freelists) {
            for (void* p : kv.second) {
                ::operator delete(p);
                a->total_reserved -= kv.first;
            }
            kv.second.clear();
        }
    }
    void* p = ::operator new(bucket, std::nothrow);
    if (!p) return nullptr;
    a->total_reserved += bucket;
    std::lock_guard<std::mutex> lk(a->mu);
    a->live[p] = bucket;
    return p;
}

void arena_free(void* handle, void* p) {
    auto* a = static_cast<Arena*>(handle);
    std::lock_guard<std::mutex> lk(a->mu);
    auto it = a->live.find(p);
    if (it == a->live.end()) return;
    a->freelists[it->second].push_back(p);
    a->live.erase(it);
}

int64_t arena_reserved_bytes(void* handle) {
    return (int64_t)static_cast<Arena*>(handle)->total_reserved.load();
}

void arena_destroy(void* handle) {
    auto* a = static_cast<Arena*>(handle);
    for (auto& kv : a->freelists)
        for (void* p : kv.second) ::operator delete(p);
    for (auto& kv : a->live) ::operator delete(kv.first);
    delete a;
}

// ---------------------------------------------------------------------------
// MultiSlot text parser (reference role: the C++ MultiSlotDataFeed's line
// parser — paddle/fluid/framework/data_feed.cc; behavior studied, code
// re-designed). One sample per line, per slot "<n> v1 ... vn". Two-pass:
// ms_scan counts samples + per-slot max width, the caller allocates padded
// [n_samples, width] arrays, ms_fill parses values straight into them.
// The buffer MUST be NUL-terminated (strtoll/strtof read past token ends).
// ---------------------------------------------------------------------------

static inline const char* ms_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

long long ms_scan(const char* buf, long long len, int n_slots,
                  long long* max_widths) {
    const char* p = buf;
    const char* end = buf + len;
    for (int s = 0; s < n_slots; ++s) max_widths[s] = 0;
    long long n_samples = 0;
    while (p < end) {
        p = ms_ws(p, end);
        if (p < end && *p == '\n') { ++p; continue; }
        if (p >= end) break;
        for (int s = 0; s < n_slots; ++s) {
            p = ms_ws(p, end);
            // strtoll would skip '\n' as whitespace and silently merge a
            // short line with the next one — a missing slot must ERROR
            if (p >= end || *p == '\n') return -1;
            char* q;
            long long n = strtoll(p, &q, 10);
            if (q == p || n < 0) return -1;
            p = q;
            if (n > max_widths[s]) max_widths[s] = n;
            for (long long i = 0; i < n; ++i) {
                p = ms_ws(p, end);
                const char* t = p;
                while (p < end && *p != ' ' && *p != '\t' && *p != '\n'
                       && *p != '\r') ++p;
                if (p == t) return -1;  // fewer values than declared
            }
        }
        p = ms_ws(p, end);
        if (p < end) {
            if (*p != '\n') return -1;  // trailing tokens: slot mismatch
            ++p;
        }
        ++n_samples;
    }
    return n_samples;
}

static inline bool ms_tok_end(const char* p, const char* end) {
    // a parsed number must terminate at whitespace/newline/end; stopping
    // mid-token ("2.0" under strtoll) would desync the line framing
    return p >= end || *p == ' ' || *p == '\t' || *p == '\r'
           || *p == '\n' || *p == '\0';
}

int ms_fill(const char* buf, long long len, int n_slots,
            const uint8_t* is_float, const long long* widths, void** outs,
            long long n_samples) {
    const char* p = buf;
    const char* end = buf + len;
    long long row = 0;
    while (p < end) {
        p = ms_ws(p, end);
        if (p < end && *p == '\n') { ++p; continue; }
        if (p >= end) break;
        if (row >= n_samples) return -1;  // MUST match ms_scan's count
        for (int s = 0; s < n_slots; ++s) {
            p = ms_ws(p, end);
            if (p >= end || *p == '\n') return -1;  // short line
            char* q;
            long long n = strtoll(p, &q, 10);
            if (q == p || n < 0 || n > widths[s] || !ms_tok_end(q, end))
                return -1;
            p = q;
            long long base = row * widths[s];
            for (long long i = 0; i < n; ++i) {
                p = ms_ws(p, end);
                if (p >= end || *p == '\n') return -1;  // short line
                char* r;
                if (is_float[s]) {
                    float v = strtof(p, &r);
                    if (r == p || !ms_tok_end(r, end)) return -1;
                    static_cast<float*>(outs[s])[base + i] = v;
                } else {
                    long long v = strtoll(p, &r, 10);
                    if (r == p || !ms_tok_end(r, end)) return -1;
                    static_cast<int64_t*>(outs[s])[base + i] = v;
                }
                p = r;
            }
        }
        p = ms_ws(p, end);
        if (p < end) {
            if (*p != '\n' && *p != '\0') return -1;  // trailing junk
            ++p;
        }
        ++row;
    }
    return 0;
}

}  // extern "C"
