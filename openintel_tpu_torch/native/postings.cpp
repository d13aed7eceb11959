// Native index-build core: tokenize -> vocab -> CSR postings in one pass.
//
// This is where host throughput caps index-build docs/sec (SURVEY.md §7 step
// 7): the Python path materialises per-document token lists and walks dicts
// per token; this C++ pass streams bytes, interns tokens in one hash map, and
// appends (doc, tf) pairs directly into per-term postings vectors.
//
// Tokenizer semantics match tokenizer.cpp (ASCII; callers route non-ASCII
// corpora to the Python builder). Term ids are assigned in first-seen order
// starting at 1 (id 0 = padding), matching openintel_tpu_torch.ops.tokenizer.Vocab.
// Postings within a term are doc-ascending by construction (docs stream in
// order), matching the Python builder exactly.

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct TermPostings {
    std::vector<int32_t> docs;
    std::vector<float> tfs;
    int64_t last_doc = -1;
};

struct Builder {
    std::unordered_map<std::string, int32_t> vocab;  // token -> id (1-based)
    std::vector<TermPostings> terms;                 // index 0 unused (pad)
    std::vector<float> doc_len;
    std::vector<std::string> id_to_token;            // [0] = ""
    int64_t nnz = 0;

    Builder() {
        terms.emplace_back();
        id_to_token.emplace_back();
    }
};

}  // namespace

extern "C" {

void* postings_build(const char* buf, const int64_t* doc_offsets, int64_t n_docs) {
    auto* b = new Builder();
    b->doc_len.reserve(n_docs);
    std::string token;
    token.reserve(64);
    for (int64_t d = 0; d < n_docs; ++d) {
        const char* p = buf + doc_offsets[d];
        const char* end = buf + doc_offsets[d + 1];
        int64_t len = 0;
        token.clear();
        auto flush = [&]() {
            if (token.empty()) return;
            ++len;
            auto it = b->vocab.find(token);
            int32_t id;
            if (it == b->vocab.end()) {
                id = static_cast<int32_t>(b->terms.size());
                b->vocab.emplace(token, id);
                b->terms.emplace_back();
                b->id_to_token.push_back(token);
            } else {
                id = it->second;
            }
            TermPostings& tp = b->terms[id];
            if (tp.last_doc == d) {
                tp.tfs.back() += 1.0f;
            } else {
                tp.last_doc = d;
                tp.docs.push_back(static_cast<int32_t>(d));
                tp.tfs.push_back(1.0f);
                ++b->nnz;
            }
            token.clear();
        };
        while (p < end) {
            unsigned char c = static_cast<unsigned char>(*p++);
            if (c >= 'A' && c <= 'Z') c += 32;
            if ((c >= 'a' && c <= 'z') || (c >= '0' && c <= '9')) {
                token.push_back(static_cast<char>(c));
            } else {
                flush();
            }
        }
        flush();
        b->doc_len.push_back(static_cast<float>(len));
    }
    return b;
}

int64_t postings_n_terms(void* h) {  // includes the padding slot 0
    return static_cast<Builder*>(h)->terms.size();
}

int64_t postings_nnz(void* h) { return static_cast<Builder*>(h)->nnz; }

int64_t postings_vocab_bytes(void* h) {
    auto* b = static_cast<Builder*>(h);
    int64_t total = 0;
    for (const auto& t : b->id_to_token) total += static_cast<int64_t>(t.size());
    return total;
}

// term_offsets: (n_terms + 1); doc_ids/tf: (nnz); doc_len: (n_docs);
// df: (n_terms); vocab_buf: concatenated tokens; vocab_offs: (n_terms + 1).
void postings_export(
    void* h,
    int64_t* term_offsets,
    int32_t* doc_ids,
    float* tf,
    float* doc_len,
    int32_t* df,
    char* vocab_buf,
    int64_t* vocab_offs
) {
    auto* b = static_cast<Builder*>(h);
    int64_t w = 0;
    int64_t vb = 0;
    term_offsets[0] = 0;
    vocab_offs[0] = 0;
    for (size_t t = 0; t < b->terms.size(); ++t) {
        const TermPostings& tp = b->terms[t];
        std::memcpy(doc_ids + w, tp.docs.data(), tp.docs.size() * sizeof(int32_t));
        std::memcpy(tf + w, tp.tfs.data(), tp.tfs.size() * sizeof(float));
        w += static_cast<int64_t>(tp.docs.size());
        term_offsets[t + 1] = w;
        df[t] = static_cast<int32_t>(tp.docs.size());
        const std::string& tok = b->id_to_token[t];
        std::memcpy(vocab_buf + vb, tok.data(), tok.size());
        vb += static_cast<int64_t>(tok.size());
        vocab_offs[t + 1] = vb;
    }
    std::memcpy(
        doc_len, b->doc_len.data(), b->doc_len.size() * sizeof(float)
    );
}

void postings_free(void* h) { delete static_cast<Builder*>(h); }

}  // extern "C"
