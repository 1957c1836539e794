// Byte-level BPE tokenizer — the framework's native hot-path component.
//
// The reference framework is pure Go (SURVEY.md §2 "Native components:
// none"); the TPU build adds native code where the serving hot path needs
// it (task brief: runtime around the XLA compute path). Tokenization is
// the classic case: per-request, CPU-bound, allocation-heavy in Python,
// and entirely outside XLA's domain.
//
// Algorithm: greedy rank-based BPE over raw bytes (the GPT-2 family's
// merge loop, re-implemented from the published algorithm):
//   1. each input byte starts as its own symbol (ids 0..255);
//   2. repeatedly merge the adjacent pair with the lowest merge rank
//      until no mergeable pair remains;
//   3. emit vocabulary ids (merged symbols get ids 256+rank by default,
//      or explicit ids from the vocab file).
// Model file format (one merge per line): "left right" where left/right
// are previously-defined symbols spelled as byte escapes (see parse_sym).
//
// C ABI (ctypes-friendly): opaque handle, int64 lengths, caller-owned
// buffers. No exceptions cross the boundary.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
    size_t operator()(const std::pair<int32_t, int32_t>& p) const {
        return (static_cast<size_t>(static_cast<uint32_t>(p.first)) << 32) ^
               static_cast<uint32_t>(p.second);
    }
};

struct Tokenizer {
    // merge rank: (left_id, right_id) -> rank; merged id = 256 + rank
    std::unordered_map<std::pair<int32_t, int32_t>, int32_t, PairHash> ranks;
    // id -> byte string it decodes to
    std::vector<std::string> pieces;
    int32_t n_special = 0;  // special ids occupy the tail of the id space

    Tokenizer() {
        pieces.reserve(256);
        for (int i = 0; i < 256; ++i) {
            pieces.emplace_back(1, static_cast<char>(i));
        }
    }

    int32_t vocab_size() const {
        return static_cast<int32_t>(pieces.size()) + n_special;
    }

    // Returns false (and changes nothing) for a duplicate pair — ranks and
    // pieces must stay in lockstep or later ids decode to the wrong bytes.
    bool add_merge(int32_t left, int32_t right) {
        int32_t rank = static_cast<int32_t>(ranks.size());
        if (!ranks.emplace(std::make_pair(left, right), rank).second) {
            return false;
        }
        pieces.push_back(pieces[left] + pieces[right]);
        return true;
    }

    // O(n log n) merge: doubly-linked list of live symbols + a min-heap of
    // (rank, position) candidates with lazy invalidation. Equal-rank
    // candidates pop leftmost-first, matching the greedy reference scan.
    void encode(const uint8_t* data, int64_t len, std::vector<int32_t>& out) const {
        out.clear();
        if (len <= 0) return;
        std::vector<int32_t> ids(data, data + len);
        std::vector<int64_t> prev(len), next(len);
        for (int64_t i = 0; i < len; ++i) {
            prev[i] = i - 1;
            next[i] = i + 1 < len ? i + 1 : -1;
        }
        struct Cand {
            int32_t rank;
            int64_t pos;       // left symbol's position
            int32_t left, right;  // ids at push time (for lazy validation)
            bool operator>(const Cand& o) const {
                return rank != o.rank ? rank > o.rank : pos > o.pos;
            }
        };
        std::priority_queue<Cand, std::vector<Cand>, std::greater<Cand>> heap;
        auto push_cand = [&](int64_t i) {
            if (i < 0) return;  // leftmost symbol has prev == -1
            int64_t j = next[i];
            if (j < 0) return;
            auto it = ranks.find({ids[i], ids[j]});
            if (it != ranks.end()) heap.push({it->second, i, ids[i], ids[j]});
        };
        for (int64_t i = 0; i + 1 < len; ++i) push_cand(i);
        std::vector<bool> dead(len, false);
        while (!heap.empty()) {
            Cand c = heap.top();
            heap.pop();
            int64_t i = c.pos, j = dead[c.pos] ? -1 : next[c.pos];
            if (j < 0 || dead[i] || dead[j] || ids[i] != c.left || ids[j] != c.right) {
                continue;  // stale candidate
            }
            ids[i] = 256 + c.rank;
            dead[j] = true;
            next[i] = next[j];
            if (next[j] >= 0) prev[next[j]] = i;
            push_cand(prev[i]);
            push_cand(i);
        }
        out.reserve(len);
        for (int64_t i = 0; i >= 0; i = next[i]) out.push_back(ids[i]);
    }

    int64_t decode(const int32_t* ids, int64_t n, std::string& out) const {
        out.clear();
        for (int64_t i = 0; i < n; ++i) {
            int32_t id = ids[i];
            if (id < 0 || id >= static_cast<int32_t>(pieces.size())) continue;  // skip specials/oob
            out += pieces[id];
        }
        return static_cast<int64_t>(out.size());
    }
};

}  // namespace

extern "C" {

// Build from a merges buffer: lines of "left right" (ids, decimal).
// n_special reserves ids at the top of the vocab (pad/bos/eos...).
void* gofr_tok_new(const char* merges, int64_t merges_len, int32_t n_special) {
    auto* t = new Tokenizer();
    t->n_special = n_special;
    const char* p = merges;
    const char* end = merges + merges_len;
    while (p < end) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        const char* line_end = nl ? nl : end;
        // parse "int int"; skip any line that isn't exactly that (headers,
        // comments, blanks) — strtol signals "no digits" via after == p
        char* after = nullptr;
        long left = strtol(p, &after, 10);
        if (after != p && after < line_end) {
            const char* mid = after;
            long right = strtol(mid, &after, 10);
            // operands must name already-defined PIECES (merged symbols or
            // bytes), never special-range ids — pieces[] indexing below
            long defined = static_cast<long>(t->pieces.size());
            if (after != mid && left >= 0 && right >= 0 &&
                left < defined && right < defined) {
                t->add_merge(static_cast<int32_t>(left), static_cast<int32_t>(right));
            }
        }
        p = nl ? nl + 1 : end;
    }
    return t;
}

void gofr_tok_free(void* handle) { delete static_cast<Tokenizer*>(handle); }

int32_t gofr_tok_vocab_size(void* handle) {
    return static_cast<Tokenizer*>(handle)->vocab_size();
}

// Encode utf-8 bytes into out (capacity out_cap); returns the id count
// (which may exceed out_cap — caller re-calls with a larger buffer).
int64_t gofr_tok_encode(void* handle, const uint8_t* text, int64_t text_len,
                        int32_t* out, int64_t out_cap) {
    thread_local std::vector<int32_t> ids;
    static_cast<Tokenizer*>(handle)->encode(text, text_len, ids);
    int64_t n = static_cast<int64_t>(ids.size());
    if (out && out_cap > 0) {
        memcpy(out, ids.data(), sizeof(int32_t) * std::min(n, out_cap));
    }
    return n;
}

// Decode ids into out (capacity out_cap bytes); returns byte count.
int64_t gofr_tok_decode(void* handle, const int32_t* ids, int64_t n,
                        uint8_t* out, int64_t out_cap) {
    thread_local std::string buf;
    int64_t need = static_cast<Tokenizer*>(handle)->decode(ids, n, buf);
    if (out && out_cap > 0) {
        memcpy(out, buf.data(), std::min(need, out_cap));
    }
    return need;
}

// Batch pad/pack: rows of variable-length int32 ids -> a [n_rows, width]
// row-major buffer (pad_id fill) + per-row lengths. The serving batcher's
// per-request Python loop replaced with one native call.
void gofr_pack_rows(const int32_t* flat, const int64_t* row_lens, int64_t n_rows,
                    int64_t width, int32_t pad_id, int32_t* out, int32_t* out_lens) {
    int64_t off = 0;
    for (int64_t r = 0; r < n_rows; ++r) {
        int64_t len = row_lens[r];
        int64_t keep = len < width ? len : width;
        // overlong rows keep their LAST tokens (recency wins for next-token
        // prediction — matches _TransformerRunner.prepare)
        const int32_t* src = flat + off + (len - keep);
        int32_t* dst = out + r * width;
        memcpy(dst, src, sizeof(int32_t) * keep);
        for (int64_t i = keep; i < width; ++i) dst[i] = pad_id;
        out_lens[r] = static_cast<int32_t>(keep);
        off += len;
    }
}

}  // extern "C"
