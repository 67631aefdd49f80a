// Native FASTA/FASTQ decoder for cbl_tpu.
//
// Counterpart of the reference's native layer: where imartayan/CBL vendors
// C++ for its hot containers (`/root/reference/cxx/`) and delegates FASTA/Q
// parsing to the needletail crate (`/root/reference/examples/cbl.rs:8,112-115`),
// our hot path is on the device, and the host-side bottleneck is feeding it.  This
// parser turns a (possibly gzipped) FASTA/FASTQ file straight into the 2-bit
// code stream + record offsets the device pipeline consumes, skipping invalid
// characters exactly like the reference's filter_map
// (`/root/reference/src/kmer.rs:131-135`).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

// A=0, C=1, T=2, G=3 (reference encoding, `/root/reference/src/kmer.rs:11`);
// 255 = skip.
struct CodeTable {
  uint8_t t[256];
  CodeTable() {
    memset(t, 255, sizeof(t));
    t[(unsigned)'A'] = 0; t[(unsigned)'a'] = 0;
    t[(unsigned)'C'] = 1; t[(unsigned)'c'] = 1;
    t[(unsigned)'T'] = 2; t[(unsigned)'t'] = 2;
    t[(unsigned)'G'] = 3; t[(unsigned)'g'] = 3;
  }
};
const CodeTable kCodes;

struct Result {
  uint8_t* codes;
  uint64_t n_codes;
  uint64_t* offsets;  // n_records + 1 entries; offsets[i]..offsets[i+1] = record i
  uint64_t n_records;
  int error;  // 0 ok, 1 open failed, 2 parse error
};

class GzReader {
 public:
  explicit GzReader(const char* path) : f_(gzopen(path, "rb")) {
    if (f_) gzbuffer(f_, 1 << 20);
  }
  ~GzReader() { if (f_) gzclose(f_); }
  bool ok() const { return f_ != nullptr; }
  // Returns bytes read, 0 on EOF.
  size_t read(char* buf, size_t n) {
    int r = gzread(f_, buf, (unsigned)n);
    return r > 0 ? (size_t)r : 0;
  }

 private:
  gzFile f_;
};

enum class State {
  kStart,
  kFastaHeader,   // inside '>' header line
  kFastaSeq,      // sequence lines of a FASTA record
  kFastqHeader,   // inside '@' header line
  kFastqSeq,      // sequence line(s) of a FASTQ record
  kFastqPlus,     // inside '+' line
  kFastqQual,     // quality characters (counted against seq length)
};

}  // namespace

extern "C" {

Result* fastx_parse(const char* path) {
  Result* res = (Result*)calloc(1, sizeof(Result));
  GzReader reader(path);
  if (!reader.ok()) {
    res->error = 1;
    return res;
  }

  std::vector<uint8_t> codes;
  std::vector<uint64_t> offsets;
  codes.reserve(1 << 20);
  offsets.push_back(0);

  State state = State::kStart;
  uint64_t seq_len_raw = 0;   // raw sequence bytes of current FASTQ record
  uint64_t qual_seen = 0;     // quality bytes consumed so far
  bool at_line_start = true;

  const size_t kBuf = 1 << 20;
  std::vector<char> buf(kBuf);
  size_t got;
  while ((got = reader.read(buf.data(), kBuf)) > 0) {
    for (size_t i = 0; i < got; i++) {
      unsigned char c = (unsigned char)buf[i];
      bool newline = (c == '\n');
      switch (state) {
        case State::kStart:
          if (c == '>') state = State::kFastaHeader;
          else if (c == '@') state = State::kFastqHeader;
          // else: leading junk/blank lines ignored
          break;
        case State::kFastaHeader:
          if (newline) state = State::kFastaSeq;
          break;
        case State::kFastaSeq:
          if (at_line_start && c == '>') {
            offsets.push_back(codes.size());
            state = State::kFastaHeader;
          } else if (!newline && c != '\r') {
            uint8_t v = kCodes.t[c];
            if (v != 255) codes.push_back(v);
          }
          break;
        case State::kFastqHeader:
          if (newline) {
            state = State::kFastqSeq;
            seq_len_raw = 0;
          }
          break;
        case State::kFastqSeq:
          if (at_line_start && c == '+') {
            state = State::kFastqPlus;
          } else if (!newline && c != '\r') {
            seq_len_raw++;
            uint8_t v = kCodes.t[c];
            if (v != 255) codes.push_back(v);
          }
          break;
        case State::kFastqPlus:
          if (newline) {
            state = State::kFastqQual;
            qual_seen = 0;
          }
          break;
        case State::kFastqQual:
          if (!newline && c != '\r') {
            qual_seen++;
          }
          if (qual_seen >= seq_len_raw) {
            offsets.push_back(codes.size());
            state = State::kStart;
          }
          break;
      }
      at_line_start = newline;
    }
  }
  // final record end (FASTA last record, or truncated FASTQ)
  if (offsets.back() != codes.size() || state == State::kFastaSeq) {
    offsets.push_back(codes.size());
  }
  // Drop empty trailing records.
  while (offsets.size() > 1 && offsets[offsets.size() - 1] == offsets[offsets.size() - 2]) {
    offsets.pop_back();
  }

  res->n_codes = codes.size();
  res->codes = (uint8_t*)malloc(codes.size() ? codes.size() : 1);
  memcpy(res->codes, codes.data(), codes.size());
  res->n_records = offsets.size() - 1;
  res->offsets = (uint64_t*)malloc(offsets.size() * sizeof(uint64_t));
  memcpy(res->offsets, offsets.data(), offsets.size() * sizeof(uint64_t));
  return res;
}

void fastx_free(Result* res) {
  if (!res) return;
  free(res->codes);
  free(res->offsets);
  free(res);
}

// Pack a 2-bit code stream 16 bases/uint32, base s at bits
// [30 - 2*(s%16), 32 - 2*(s%16)) of word s/16 (big-endian bases) — the
// device input layout of cbl_tpu.kmer.pack_stream.  n must be a multiple
// of 16.  The inner loop auto-vectorizes under -O3 -march=native; this
// replaces a strided-numpy pack that dominated the host side of the
// insert/query stream path.
void cbl_pack_stream(const uint8_t* codes, uint64_t n, uint32_t* out) {
  const uint64_t nw = n / 16;
  for (uint64_t w = 0; w < nw; ++w) {
    const uint8_t* c = codes + w * 16;
    uint32_t v = 0;
    for (int j = 0; j < 16; ++j) v = (v << 2) | (uint32_t)c[j];
    out[w] = v;
  }
}

}  // extern "C"
