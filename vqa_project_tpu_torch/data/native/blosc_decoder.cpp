// Native blosc-v1 frame decoder for the zarr reader (a copy of
// vqa_project_tpu/data/native/blosc_decoder.cpp).
//
// zarr-python's default codec is Blosc(cname='lz4', shuffle=SHUFFLE), so
// feature stores written by the reference's preprocessors arrive as blosc
// frames. This decoder implements the blosc-1.x container (header + block
// offsets + per-block split streams), LZ4 block decompression, zlib
// streams, and byte-unshuffle: enough for every frame zarr-python emits
// with the lz4/zlib compressors.
//
// Exposed C ABI:
//   int vqax_blosc_decompress(const uint8_t* src, size_t srclen,
//                             uint8_t* dst, size_t dstlen);
// returns the number of bytes written, or a negative error code.
//
// Held against the committed frames of tests/fixtures/blosc/ and, where
// one exists, the system libblosc (tests/test_torch_zarr.py).

#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

constexpr int kMaxSplits = 16;
constexpr int kMinBuffersize = 128;

// header flag bits (c-blosc blosc.h)
constexpr uint8_t kDoShuffle = 0x1;
constexpr uint8_t kMemcpyed = 0x2;
constexpr uint8_t kDoBitShuffle = 0x4;
constexpr uint8_t kDontSplit = 0x10;

// compressor format codes (flags bits 5-7)
constexpr int kBloscLZ = 0;
constexpr int kLZ4 = 1;
constexpr int kSnappy = 2;
constexpr int kZlib = 3;
constexpr int kZstd = 4;

uint32_t le32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

// LZ4 block-format decompression. Returns bytes written or -1.
int64_t lz4_decompress_block(const uint8_t* src, int64_t srclen,
                             uint8_t* dst, int64_t dstcap) {
  const uint8_t* s = src;
  const uint8_t* send = src + srclen;
  uint8_t* d = dst;
  uint8_t* dend = dst + dstcap;

  while (s < send) {
    uint8_t token = *s++;
    // literals
    int64_t litlen = token >> 4;
    if (litlen == 15) {
      uint8_t c;
      do {
        if (s >= send) return -1;
        c = *s++;
        litlen += c;
      } while (c == 255);
    }
    if (s + litlen > send || d + litlen > dend) return -1;
    std::memcpy(d, s, static_cast<size_t>(litlen));
    s += litlen;
    d += litlen;
    if (s >= send) break;  // last literals reached

    // match
    if (s + 2 > send) return -1;
    int64_t offset = s[0] | (s[1] << 8);
    s += 2;
    if (offset == 0 || d - offset < dst) return -1;
    int64_t matchlen = token & 0xF;
    if (matchlen == 15) {
      uint8_t c;
      do {
        if (s >= send) return -1;
        c = *s++;
        matchlen += c;
      } while (c == 255);
    }
    matchlen += 4;
    if (d + matchlen > dend) return -1;
    const uint8_t* m = d - offset;
    for (int64_t i = 0; i < matchlen; ++i) d[i] = m[i];  // may overlap
    d += matchlen;
  }
  return d - dst;
}

// byte unshuffle: input holds `typesize` planes of bsize/typesize bytes.
void unshuffle(int typesize, int64_t bsize, const uint8_t* src,
               uint8_t* dst) {
  int64_t neblock = bsize / typesize;
  for (int j = 0; j < typesize; ++j) {
    const uint8_t* plane = src + j * neblock;
    for (int64_t i = 0; i < neblock; ++i) {
      dst[i * typesize + j] = plane[i];
    }
  }
  int64_t done = neblock * typesize;
  if (done < bsize) std::memcpy(dst + done, src + done, bsize - done);
}

}  // namespace

extern "C" int vqax_blosc_decompress(const uint8_t* src, size_t srclen,
                                     uint8_t* dst, size_t dstlen) {
  if (srclen < 16) return -2;
  const uint8_t version = src[0];
  const uint8_t flags = src[2];
  const int typesize = src[3];
  const int64_t nbytes = le32(src + 4);
  const int64_t blocksize = le32(src + 8);
  const int64_t cbytes = le32(src + 12);
  if (version < 1 || version > 2) return -3;
  if (static_cast<size_t>(cbytes) > srclen) return -4;
  if (static_cast<size_t>(nbytes) > dstlen) return -5;
  if (nbytes == 0) return 0;

  if (flags & kMemcpyed) {
    if (static_cast<size_t>(nbytes) + 16 > srclen) return -4;
    std::memcpy(dst, src + 16, static_cast<size_t>(nbytes));
    return static_cast<int>(nbytes);
  }
  if (flags & kDoBitShuffle) return -6;  // not emitted by zarr defaults

  const int compformat = (flags >> 5) & 0x7;
  const bool shuffle = (flags & kDoShuffle) && typesize > 1;
  const bool dont_split = flags & kDontSplit;

  const int64_t nblocks = (nbytes + blocksize - 1) / blocksize;
  const int64_t leftover = nbytes % blocksize;
  const uint8_t* bstarts = src + 16;
  if (16 + 4 * nblocks > static_cast<int64_t>(srclen)) return -4;

  std::vector<uint8_t> tmp(static_cast<size_t>(blocksize));

  for (int64_t j = 0; j < nblocks; ++j) {
    const bool leftoverblock = (j == nblocks - 1) && (leftover != 0);
    const int64_t bsize = leftoverblock ? leftover : blocksize;
    int64_t off = le32(bstarts + 4 * j);
    if (off < 0 || static_cast<size_t>(off) >= srclen) return -4;
    const uint8_t* bsrc = src + off;

    // split streams (c-blosc blosc_d): full blocks of small typesize are
    // split into one stream per byte-plane whenever the compressor chose
    // to split (the kDontSplit header bit carries that choice; splitting
    // is independent of shuffle)
    int nsplits = 1;
    if (typesize <= kMaxSplits && typesize > 0 &&
        blocksize / typesize >= kMinBuffersize && !dont_split &&
        !leftoverblock) {
      nsplits = typesize;
    }
    const int64_t neblock = bsize / nsplits;
    uint8_t* bout = shuffle ? tmp.data() : dst + j * blocksize;

    for (int s = 0; s < nsplits; ++s) {
      if (bsrc + 4 > src + srclen) return -4;
      const int32_t scbytes = static_cast<int32_t>(le32(bsrc));
      bsrc += 4;
      // a truncated/corrupt frame may claim more compressed bytes than
      // remain in the input; every codec below reads scbytes from bsrc
      if (scbytes < 0 || bsrc + scbytes > src + srclen) return -4;
      uint8_t* sout = bout + s * neblock;
      if (scbytes == neblock) {  // stored uncompressed
        if (bsrc + neblock > src + srclen) return -4;
        std::memcpy(sout, bsrc, static_cast<size_t>(neblock));
      } else if (scbytes == 0) {
        std::memset(sout, 0, static_cast<size_t>(neblock));
      } else {
        int64_t n;
        switch (compformat) {
          case kLZ4:
            n = lz4_decompress_block(bsrc, scbytes, sout, neblock);
            break;
          case kZlib: {
            uLongf outlen = static_cast<uLongf>(neblock);
            int rc = uncompress(sout, &outlen, bsrc,
                                static_cast<uLong>(scbytes));
            n = (rc == Z_OK) ? static_cast<int64_t>(outlen) : -1;
            break;
          }
          case kBloscLZ:
          case kSnappy:
          case kZstd:
          default:
            return -7;  // codec not built in
        }
        if (n != neblock) return -8;
      }
      bsrc += scbytes;
    }
    if (shuffle) {
      unshuffle(typesize, bsize, tmp.data(), dst + j * blocksize);
    }
  }
  return static_cast<int>(nbytes);
}
