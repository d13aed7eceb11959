// Streaming batch tokenizer — the host-side native component of the index
// build pipeline (SURVEY.md §7 step 7: C++ where Python throughput caps
// index-build docs/sec).
//
// Semantics: ASCII lowercase; any byte that is not [0-9a-z] after lowering is
// a separator (non-ASCII bytes >= 0x80 are separators). This matches the
// Python tokenizer exactly for ASCII input; callers route non-ASCII documents
// to the Python path (openintel_tpu_torch/ops/tokenizer.py) so exotic-unicode
// lowercasing differences can never change an index.
//
// C ABI (ctypes): documents arrive as one concatenated buffer with offsets;
// tokens leave as space-joined runs per document with end-offsets. The output
// for a document is never longer than its input (separators only shrink), so
// the caller sizes out_buf = len(buf).

#include <cstdint>
#include <cstring>

extern "C" {

// Returns total bytes written, or -1 if out_cap is too small.
int64_t tokenize_batch(
    const char* buf,
    const int64_t* doc_offsets,  // (n_docs + 1)
    int64_t n_docs,
    char* out_buf,
    int64_t out_cap,
    int64_t* out_offsets  // (n_docs + 1), out_offsets[0] set to 0 by callee
) {
    int64_t w = 0;
    out_offsets[0] = 0;
    for (int64_t d = 0; d < n_docs; ++d) {
        const char* p = buf + doc_offsets[d];
        const char* end = buf + doc_offsets[d + 1];
        bool in_token = false;
        bool first_token = true;
        while (p < end) {
            unsigned char c = static_cast<unsigned char>(*p++);
            if (c >= 'A' && c <= 'Z') c += 32;  // ASCII lowercase
            bool alnum = (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
            if (alnum) {
                if (!in_token) {
                    if (!first_token) {
                        if (w >= out_cap) return -1;
                        out_buf[w++] = ' ';
                    }
                    in_token = true;
                    first_token = false;
                }
                if (w >= out_cap) return -1;
                out_buf[w++] = static_cast<char>(c);
            } else {
                in_token = false;
            }
        }
        out_offsets[d + 1] = w;
    }
    return w;
}

}  // extern "C"
