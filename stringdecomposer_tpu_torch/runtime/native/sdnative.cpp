// Native host runtime for stringdecomposer_tpu_torch (a copy of the JAX
// package's runtime/native/sdnative.cpp; the port builds it itself).
//
// The device kernels produce compact per-window block records; everything that
// remains on the host path at production scale (merging windows to global
// coordinates, the halo-duplicate suppression, raw-TSV formatting, FASTA
// encoding/validation, homopolymer compression) is implemented here and
// loaded via ctypes (runtime/native.py), with pure-NumPy fallbacks.
//
// Semantics mirror the reference C++ host logic exactly:
//   - PostProcessing overlap rule        (reference: src/main.cpp:287-302)
//   - SaveBatch 7-column raw TSV          (reference: src/main.cpp:272-285)
//   - ACGTN validation                    (reference: src/main.cpp:330-344)
//   - homopolymer compression             (reference: main.py:87-92)
//
// Build: runtime/native.py compiles it with g++ at first use, into
// stringdecomposer_tpu_torch/build/<source hash>/libsdnative.so.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// Encode ACGTN -> 0..4 into out; returns -1 on success or the index of the
// first invalid character. 'N' maps to 4 (a real symbol in scoring).
int64_t sd_encode_validate(const char* seq, int64_t n, int8_t* out) {
    static int8_t table[256];
    static bool init = false;
    if (!init) {
        memset(table, -1, sizeof(table));
        table[(unsigned char)'A'] = 0;
        table[(unsigned char)'C'] = 1;
        table[(unsigned char)'G'] = 2;
        table[(unsigned char)'T'] = 3;
        table[(unsigned char)'N'] = 4;
        init = true;
    }
    for (int64_t i = 0; i < n; ++i) {
        int8_t c = table[(unsigned char)seq[i]];
        if (c < 0) return i;
        out[i] = c;
    }
    return -1;
}

// Homopolymer-compress codes in place semantics: writes compressed sequence
// to out, returns its length (reference main.py:87-92).
int64_t sd_homo_compress(const int8_t* seq, int64_t n, int8_t* out) {
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (m == 0 || out[m - 1] != seq[i]) out[m++] = seq[i];
    }
    return m;
}

// Halo-duplicate suppression (reference src/main.cpp:287-302), exact
// transcription including the quirk that the landing block is emitted
// without its own overlap check. blocks: [n,4] int32 rows (monomer, start,
// end, identity). keep: out bool array. Returns kept count.
int64_t sd_postprocess(const int32_t* blocks, int64_t n, uint8_t* keep) {
    memset(keep, 0, n);
    int64_t kept = 0;
    int64_t i = 0;
    while (i < n) {
        int64_t lim = i + 7 < n ? i + 7 : n;
        for (int64_t j = i + 1; j < lim; ++j) {
            int32_t end_i = blocks[i * 4 + 2];
            int32_t start_j = blocks[j * 4 + 1];
            int32_t end_j = blocks[j * 4 + 2];
            if ((end_i - start_j) * 2 > (end_j - start_j)) {
                keep[i] = 1;
                ++kept;
                i = j + 1;
                break;
            }
        }
        if (i < n) {
            keep[i] = 1;
            ++kept;
        }
        ++i;
    }
    return kept;
}

// The same rule over a stream of blocks that arrives a window at a time
// (the port's ops/oracle.PostprocessStream, run over int32 records).
// blocks: [n,4] rows, n = bounds[n_bounds - 1]: the blocks still held from
// earlier pushes, then a run of windows whose ends are bounds[]. Each window
// is drained as PostprocessStream.push drains it: index i is decided only
// once its 6-block look-ahead has arrived, and a jump that lands one past the
// blocks seen so far leaves *landing set, so that the landing block is
// emitted unconditionally when it arrives. With `final`, the last window is
// also drained to the end (PostprocessStream.finish). emit: the indices of
// the emitted blocks in order; cuts[k]: how many were emitted by the end of
// window k. Returns the index of the first block still held.
int64_t sd_postprocess_stream(const int32_t* blocks, const int64_t* bounds,
                              int64_t n_bounds, int32_t final, int32_t* landing,
                              int64_t* emit, int64_t* cuts) {
    int64_t i = 0, w = 0;
    for (int64_t k = 0; k < n_bounds; ++k) {
        const int64_t nb = bounds[k];
        const int passes = (final && k == n_bounds - 1) ? 2 : 1;
        for (int pass = 0; pass < passes; ++pass) {
            const bool fin = pass == 1;
            if (*landing && nb > i) {
                emit[w++] = i++;
                *landing = 0;
            }
            while (i < nb && (fin || i + 7 <= nb)) {
                bool jumped = false;
                const int64_t lim = i + 7 < nb ? i + 7 : nb;
                for (int64_t j = i + 1; j < lim; ++j) {
                    const int64_t end_i = blocks[i * 4 + 2];
                    const int64_t start_j = blocks[j * 4 + 1];
                    const int64_t end_j = blocks[j * 4 + 2];
                    if ((end_i - start_j) * 2 > (end_j - start_j)) {
                        emit[w++] = i;
                        i = j + 1;
                        jumped = true;
                        break;
                    }
                }
                if (i < nb) {
                    emit[w++] = i;
                } else if (jumped && !fin) {
                    *landing = 1;
                }
                ++i;
            }
            if (i > nb) i = nb;
        }
        cuts[k] = w;
    }
    return i;
}

// A whole number in decimal (negative ones too: the gap column may be).
static inline int64_t put_u64(char* out, int64_t w, long long v) {
    if (v < 0) {
        out[w++] = '-';
        v = -v;
    }
    char tmp[24];
    int k = 0;
    do {
        tmp[k++] = (char)('0' + v % 10);
        v /= 10;
    } while (v);
    while (k) out[w++] = tmp[--k];
    return w;
}

// Format the 7-column raw TSV for a read's postprocessed blocks (reference
// src/main.cpp:272-285). The identity prints like std::to_string(float),
// "%f": the record's integer cast to float is a whole number, so its six
// decimals are zeros. prev_end seeds the gap column when a read's blocks
// are formatted in chunks: the previous chunk's last end, 0 at a read's
// start. names_buf/names_off: concatenated monomer names + [M+1] offsets.
// Returns bytes written, -1 if out is too small.
int64_t sd_format_raw(
    const int32_t* blocks, int64_t n,  // [n,4] (monomer, start, end, identity)
    const char* read_name, int64_t read_name_len,
    const char* names_buf, const int64_t* names_off,
    int64_t prev_end, char* out, int64_t out_cap) {
    int64_t w = 0;
    for (int64_t b = 0; b < n; ++b) {
        int32_t m = blocks[b * 4 + 0];
        int64_t s = blocks[b * 4 + 1];
        int64_t e = blocks[b * 4 + 2];
        int32_t id = blocks[b * 4 + 3];
        int64_t name_len = names_off[m + 1] - names_off[m];
        // worst-case row size check
        if (w + read_name_len + name_len + 96 > out_cap) return -1;
        memcpy(out + w, read_name, read_name_len);
        w += read_name_len;
        out[w++] = '\t';
        memcpy(out + w, names_buf + names_off[m], name_len);
        w += name_len;
        out[w++] = '\t';
        w = put_u64(out, w, s);
        out[w++] = '\t';
        w = put_u64(out, w, e);
        out[w++] = '\t';
        w = put_u64(out, w, (long long)(float)id);
        memcpy(out + w, ".000000\t", 8);
        w += 8;
        w = put_u64(out, w, s - prev_end);
        out[w++] = '\t';
        w = put_u64(out, w, e - s);
        out[w++] = '\n';
        prev_end = e;
    }
    return w;
}

// Format the final 12-column + alt 5-column TSV rows for one read chunk
// (reference main.py:153-165). Scores print like Python "{:.2f}" — both
// glibc snprintf and CPython emit the correctly-rounded decimal conversion
// of the IEEE double, so the bytes agree (parity asserted by
// tests/test_native.py). Name columns arrive as indices into two
// concatenated name tables: `names` (full interleaved monomer order, used
// by the monomer/homo columns) and `uniq` (first-occurrence unique names,
// used by second-best and the alt rows — the reference collapses scores
// into a name-keyed dict, main.py:123-126). idx < 0 prints "None".
// alt: [n, U] row-major scores or NULL (light mode: no alt rows).
// Returns final bytes written, sets *alt_written; -1 on overflow.
static inline int64_t put_name(char* out, int64_t w, const char* buf,
                               const int64_t* off, int32_t idx) {
    if (idx < 0) {
        memcpy(out + w, "None", 4);
        return w + 4;
    }
    int64_t len = off[idx + 1] - off[idx];
    memcpy(out + w, buf + off[idx], len);
    return w + len;
}

// Memoized "%.2f" strings: identity percentages are m/L*100 ratios, so a
// whole assembly has only a few thousand distinct doubles — cache the
// snprintf result per double bit pattern (open addressing, power-of-two
// table). snprintf itself is the correctly-rounded conversion (same bytes
// as CPython's "{:.2f}"); the memo only skips repeated conversions.
struct ScoreMemo {
    static const int LOG2 = 15;           // 32768 slots
    uint64_t key[1 << LOG2];
    uint8_t len[1 << LOG2];
    char str[1 << LOG2][24];
    uint8_t used[1 << LOG2];
    ScoreMemo() { memset(used, 0, sizeof(used)); }
    int64_t put(char* out, int64_t w, double v) {
        uint64_t bits;
        memcpy(&bits, &v, 8);
        uint64_t h = (bits * 0x9E3779B97F4A7C15ull) >> (64 - LOG2);
        for (int probe = 0; probe < 8; ++probe) {
            uint64_t slot = (h + probe) & ((1 << LOG2) - 1);
            if (!used[slot]) {
                used[slot] = 1;
                key[slot] = bits;
                len[slot] = (uint8_t)snprintf(str[slot], 24, "%.2f", v);
                memcpy(out + w, str[slot], len[slot]);
                return w + len[slot];
            }
            if (key[slot] == bits) {
                memcpy(out + w, str[slot], len[slot]);
                return w + len[slot];
            }
        }
        return w + snprintf(out + w, 32, "%.2f", v);  // table pressure: direct
    }
};

int64_t sd_format_final(
    int64_t n,
    const char* read_name, int64_t read_name_len,
    const char* names_buf, const int64_t* names_off,   // full monomer order
    const char* uniq_buf, const int64_t* uniq_off,     // unique names
    int64_t n_uniq,
    const int32_t* best_idx,   // [n] into names (monomer column)
    const int32_t* best_upos,  // [n] into uniq (star column of alt rows)
    const int64_t* starts, const int64_t* ends,        // [n]
    const double* score,                               // [n]
    const int32_t* sb_idx, const double* sb_score,     // [n] into uniq
    const int32_t* hb_idx, const double* hb_score,     // [n] into names
    const int32_t* hs_idx, const double* hs_score,     // [n] into names
    const uint8_t* reliable,                           // [n]
    const double* alt,                                 // [n*n_uniq] or NULL
    double identity_th,
    char* out, int64_t out_cap,
    char* alt_out, int64_t alt_cap, int64_t* alt_written) {
    int64_t w = 0, aw = 0;
    // every name in the full table also appears in the unique table, so the
    // max unique-name length bounds all four name columns
    int64_t max_nm = 4;  // "None"
    for (int64_t u = 0; u < n_uniq; ++u) {
        int64_t len = uniq_off[u + 1] - uniq_off[u];
        if (len > max_nm) max_nm = len;
    }
    const int64_t row_pad = 256 + 4 * max_nm;
    static thread_local ScoreMemo memo;
    for (int64_t b = 0; b < n; ++b) {
        if (!(score[b] >= identity_th)) continue;
        if (w + read_name_len + row_pad > out_cap) return -1;
        memcpy(out + w, read_name, read_name_len);
        w += read_name_len;
        out[w++] = '\t';
        w = put_name(out, w, names_buf, names_off, best_idx[b]);
        out[w++] = '\t';
        w = put_u64(out, w, (long long)starts[b]);
        out[w++] = '\t';
        w = put_u64(out, w, (long long)ends[b]);
        out[w++] = '\t';
        w = memo.put(out, w, score[b]);
        out[w++] = '\t';
        w = put_name(out, w, uniq_buf, uniq_off, sb_idx[b]);
        out[w++] = '\t';
        w = memo.put(out, w, sb_score[b]);
        out[w++] = '\t';
        w = put_name(out, w, names_buf, names_off, hb_idx[b]);
        out[w++] = '\t';
        w = memo.put(out, w, hb_score[b]);
        out[w++] = '\t';
        w = put_name(out, w, names_buf, names_off, hs_idx[b]);
        out[w++] = '\t';
        w = memo.put(out, w, hs_score[b]);
        out[w++] = '\t';
        out[w++] = reliable[b] ? '+' : '?';
        out[w++] = '\n';
        if (alt != nullptr) {
            // per-block constant prefix pieces, formatted once
            char se[64];
            int64_t se_len = 0;
            se[se_len++] = '\t';
            se_len = put_u64(se, se_len, (long long)starts[b]);
            se[se_len++] = '\t';
            se_len = put_u64(se, se_len, (long long)ends[b]);
            se[se_len++] = '\t';
            const double* row = alt + b * n_uniq;
            for (int64_t u = 0; u < n_uniq; ++u) {
                if (aw + read_name_len + max_nm + 256 > alt_cap) return -1;
                memcpy(alt_out + aw, read_name, read_name_len);
                aw += read_name_len;
                alt_out[aw++] = '\t';
                aw = put_name(alt_out, aw, uniq_buf, uniq_off, (int32_t)u);
                memcpy(alt_out + aw, se, se_len);
                aw += se_len;
                aw = memo.put(alt_out, aw, row[u]);
                alt_out[aw++] = '\t';
                alt_out[aw++] = u == best_upos[b] ? '*' : '-';
                alt_out[aw++] = '\n';
            }
        }
    }
    *alt_written = aw;
    return w;
}

}  // extern "C"
