// Native FASTA parser + integer encoder for fastsk-tpu.
//
// The TPU-native counterpart of the reference's host-side data layer
// (src/fastsk/utils.py:50-96 reads FASTA in Python char-by-char; the C++
// core re-parses dictionaries in shared.cpp). One pass over a
// buffered read of the file: alternating ">label" / sequence lines,
// ASCII lowercasing, shared vocabulary table (byte -> code, 0 reserved
// unknown), ragged int32 output with offsets. Non-ASCII bytes abort with
// an error so the Python reader (which is unicode-correct) can take over.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

typedef struct {
  int32_t* data;      // concatenated codes, length total_len
  int64_t* offsets;   // n_seqs + 1 prefix offsets into data
  double* labels;     // numeric labels (classification: -1/0/1)
  int64_t n_seqs;
  int64_t total_len;
  int32_t status;     // 0 ok, nonzero error
  char err[256];
} FastaResult;

static FastaResult* make_error(FastaResult* r, int code, const char* msg) {
  r->status = code;
  snprintf(r->err, sizeof(r->err), "%s", msg);
  return r;
}

// vocab: 256-entry byte -> code table shared across calls (0 = unassigned);
// *vocab_next is the next code to hand out (starts at 1: code 0 is the
// reserved unknown, matching Vocabulary semantics).
FastaResult* fasta_parse(const char* path, int32_t* vocab, int32_t* vocab_next,
                         int32_t regression) {
  FastaResult* r = (FastaResult*)calloc(1, sizeof(FastaResult));
  FILE* f = fopen(path, "rb");
  if (!f) return make_error(r, 1, strerror(errno));

  std::vector<int32_t> data;
  std::vector<int64_t> offsets;
  std::vector<double> labels;
  data.reserve(1 << 20);
  offsets.push_back(0);

  std::string line;
  line.reserve(1 << 16);
  bool label_line = true;
  int c;
  bool eof = false;
  while (!eof) {
    line.clear();
    while ((c = fgetc(f)) != EOF && c != '\n') line.push_back((char)c);
    if (c == EOF) eof = true;
    // strip (outer whitespace only, like str.strip())
    size_t b = 0, e = line.size();
    while (b < e && isspace((unsigned char)line[b])) b++;
    while (e > b && isspace((unsigned char)line[e - 1])) e--;
    if (b == e) continue;  // blank line

    if (label_line) {
      // expect exactly one '>' separating prefix and label
      size_t gt = std::string::npos;
      for (size_t i = b; i < e; i++) {
        if (line[i] == '>') {
          if (gt != std::string::npos) {
            fclose(f);
            return make_error(r, 2, "malformed label line (multiple '>')");
          }
          gt = i;
        }
      }
      if (gt == std::string::npos) {
        fclose(f);
        return make_error(r, 2, "malformed label line (no '>')");
      }
      std::string lab = line.substr(gt + 1, e - gt - 1);
      char* endp = nullptr;
      double v;
      if (regression) {
        v = strtod(lab.c_str(), &endp);
      } else {
        // classification labels go through Python int(): reject
        // float-looking strings like "1.0" exactly as int() does
        v = (double)strtol(lab.c_str(), &endp, 10);
        while (*endp && isspace((unsigned char)*endp)) endp++;
      }
      if (endp == lab.c_str() || *endp != '\0') {
        fclose(f);
        return make_error(r, 3, "non-numeric label");
      }
      if (!regression && v != -1.0 && v != 0.0 && v != 1.0) {
        fclose(f);
        return make_error(r, 3, "classification label not in {-1, 0, 1}");
      }
      labels.push_back(v);
      label_line = false;
    } else {
      for (size_t i = b; i < e; i++) {
        unsigned char ch = (unsigned char)line[i];
        if (ch >= 128) {
          fclose(f);
          return make_error(r, 4, "non-ASCII byte: use the Python reader");
        }
        ch = (unsigned char)tolower(ch);
        int32_t code = vocab[ch];
        if (code == 0) {
          code = (*vocab_next)++;
          vocab[ch] = code;
        }
        data.push_back(code);
      }
      offsets.push_back((int64_t)data.size());
      label_line = true;
    }
  }
  fclose(f);
  if (labels.size() + 1 != offsets.size()) {
    return make_error(r, 5, "unequal number of labels and sequences");
  }

  r->n_seqs = (int64_t)labels.size();
  r->total_len = (int64_t)data.size();
  r->data = (int32_t*)malloc(sizeof(int32_t) * data.size());
  memcpy(r->data, data.data(), sizeof(int32_t) * data.size());
  r->offsets = (int64_t*)malloc(sizeof(int64_t) * offsets.size());
  memcpy(r->offsets, offsets.data(), sizeof(int64_t) * offsets.size());
  r->labels = (double*)malloc(sizeof(double) * labels.size());
  memcpy(r->labels, labels.data(), sizeof(double) * labels.size());
  r->status = 0;
  return r;
}

void fasta_free(FastaResult* r) {
  if (!r) return;
  free(r->data);
  free(r->offsets);
  free(r->labels);
  free(r);
}

}  // extern "C"
