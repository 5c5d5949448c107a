// Native multi-bleu core (C ABI, loaded via ctypes).
//
// Replaces the reference's external Perl scorer process
// (eval/multi-bleu.perl, shelled out at eval/eval.jl:38,78) with an
// in-process C++ library.  Semantics mirror the MODIFIED Moses script
// exactly — brevity penalty disabled (multi-bleu.perl:118,137-144),
// clipped cumulative n-gram counts (:65-115), closest-reference-length
// bookkeeping with ties toward the shorter reference (:50-64).
//
// The Python layer (lrcn_tpu/evaluation/bleu.py) computes the final
// logs/geometric means from the integer statistics this core accumulates,
// so float formatting stays in one place.

#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Stats {
    long long correct[5] = {0, 0, 0, 0, 0};  // 1-indexed by n
    long long total[5] = {0, 0, 0, 0, 0};
    long long hyp_len = 0;
    long long ref_len = 0;
};

// Whitespace tokenization matching Perl's split ' ' (runs of whitespace,
// leading/trailing ignored).
std::vector<std::string_view> tokenize(std::string_view line) {
    std::vector<std::string_view> out;
    size_t i = 0, n = line.size();
    while (i < n) {
        while (i < n && std::isspace(static_cast<unsigned char>(line[i])))
            ++i;
        size_t start = i;
        while (i < n && !std::isspace(static_cast<unsigned char>(line[i])))
            ++i;
        if (i > start) out.push_back(line.substr(start, i - start));
    }
    return out;
}

// n-gram key: n as one byte, then tokens joined by '\x01' (captions never
// contain control bytes; the Perl script joins with spaces which would
// collide only if tokens contained spaces — they cannot).
void count_ngrams(const std::vector<std::string_view>& words, int n,
                  std::unordered_map<std::string, int>* counts) {
    if (static_cast<int>(words.size()) < n) return;
    std::string key;
    for (size_t i = 0; i + n <= words.size(); ++i) {
        key.clear();
        key.push_back(static_cast<char>(n));
        for (int j = 0; j < n; ++j) {
            if (j) key.push_back('\x01');
            key.append(words[i + j].data(), words[i + j].size());
        }
        ++(*counts)[key];
    }
}

std::string lowered(std::string_view s) {
    std::string out(s);
    for (char& c : out)
        c = static_cast<char>(std::tolower(static_cast<unsigned char>(c)));
    return out;
}

}  // namespace

extern "C" {

void* lrcn_bleu_stats_new() { return new Stats(); }

void lrcn_bleu_stats_free(void* stats) {
    delete static_cast<Stats*>(stats);
}

// Accumulate one sentence pair: hypothesis + n_refs reference lines.
void lrcn_bleu_accumulate(void* stats_ptr, const char* hyp_c,
                          const char** refs_c, int n_refs, int lowercase) {
    Stats* stats = static_cast<Stats*>(stats_ptr);

    std::string hyp_store;
    std::string_view hyp_line(hyp_c);
    if (lowercase) {
        hyp_store = lowered(hyp_line);
        hyp_line = hyp_store;
    }
    std::vector<std::string_view> hyp_words = tokenize(hyp_line);
    const long long hlen = static_cast<long long>(hyp_words.size());

    // Max (clipped) reference n-gram counts + closest reference length
    // (multi-bleu.perl:50-81).
    std::unordered_map<std::string, int> ref_ngram;
    long long closest_diff = 9999, closest_length = 9999;
    for (int r = 0; r < n_refs; ++r) {
        std::string ref_store;
        std::string_view ref_line(refs_c[r]);
        if (lowercase) {
            ref_store = lowered(ref_line);
            ref_line = ref_store;
        }
        std::vector<std::string_view> ref_words = tokenize(ref_line);
        const long long rlen = static_cast<long long>(ref_words.size());
        const long long diff = llabs(hlen - rlen);
        if (diff < closest_diff) {
            closest_diff = diff;
            closest_length = rlen;
        } else if (diff == closest_diff && rlen < closest_length) {
            closest_length = rlen;
        }
        std::unordered_map<std::string, int> counts;
        for (int n = 1; n <= 4; ++n) count_ngrams(ref_words, n, &counts);
        for (const auto& [key, c] : counts) {
            auto it = ref_ngram.find(key);
            if (it == ref_ngram.end())
                ref_ngram.emplace(key, c);
            else if (it->second < c)
                it->second = c;
        }
    }

    stats->hyp_len += hlen;
    stats->ref_len += closest_length;

    std::unordered_map<std::string, int> hyp_counts;
    for (int n = 1; n <= 4; ++n) count_ngrams(hyp_words, n, &hyp_counts);
    for (const auto& [key, c] : hyp_counts) {
        const int n = static_cast<int>(key[0]);
        stats->total[n] += c;
        auto it = ref_ngram.find(key);
        if (it != ref_ngram.end())
            stats->correct[n] += (it->second >= c) ? c : it->second;
    }
}

// out must hold 10 long longs: correct[1..4], total[1..4], hyp_len, ref_len.
void lrcn_bleu_get(void* stats_ptr, long long* out) {
    Stats* stats = static_cast<Stats*>(stats_ptr);
    for (int n = 1; n <= 4; ++n) out[n - 1] = stats->correct[n];
    for (int n = 1; n <= 4; ++n) out[3 + n] = stats->total[n];
    out[8] = stats->hyp_len;
    out[9] = stats->ref_len;
}

}  // extern "C"
