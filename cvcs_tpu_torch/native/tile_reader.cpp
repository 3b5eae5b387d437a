// Host decode and encode tier of the port (cvcs_tpu_torch.native): a PNG
// and TIFF decoder, a PNG encoder, one background decode worker with a
// path-keyed cache, and one background PNG writer, behind a C ABI that
// cvcs_tpu_torch/native/__init__.py binds with ctypes.
//
// Port of cvcs_tpu/native/tile_reader.cpp, which decodes through libpng
// and libtiff. This source carries the TIFF container, PackBits, LZW with
// the horizontal predictor, and PNG's chunks and row filters itself, and
// takes only zlib's buffer calls (zlib_calls.h) from the system's
// libz.so.1. It includes neither png.h, tiffio.h nor zlib.h.
//
// What it decodes, it decodes byte for byte as np.asarray(PIL.Image.open(
// path)) does:
//   TIFF: the classic header in either byte order and its first IFD;
//     8-bit unsigned samples: MinIsBlack with 1 sample, or 2 with an
//     unassociated alpha; RGB with 3, or 4 with an unassociated or an
//     unnamed alpha; contiguous planes, top-left orientation, MSB-first
//     fill order; strips, or tiles cropped at the right and bottom edges;
//     compression none (1), LZW (5), Deflate (8, 32946) or PackBits
//     (32773), and the horizontal predictor (2) on LZW and Deflate.
//   PNG: 8-bit gray, gray+alpha, RGB and RGBA, not interlaced, no tRNS,
//     every chunk's CRC checked, row filters 0-4.
// Every other sub-format (palette, 16-bit, float, MinIsWhite, CMYK, YCbCr,
// JPEG, ZSTD, BigTIFF, Adam7, premultiplied alpha, an RGB image's fourth
// sample named "unspecified", which PIL drops, ...) is rejected up front
// with TR_UNSUPPORTED, and the caller decodes it with PIL. A file that is
// missing, truncated or corrupt (a bad signature, CRC or stream) gives
// TR_UNREADABLE, with the reason in tr_last_error() on the calling thread
// (and the errno of a failed system call in tr_last_errno(), else 0).
// The generic calls tell the formats apart by their first bytes; a file
// that is neither a PNG nor a TIFF but another raster PIL reads (JPEG,
// GIF, BMP, WebP) is TR_UNSUPPORTED.
//
// C ABI (the JAX library's names and signatures; status 0 on success):
//   tr_info / tr_png_info / tr_tiff_info (path, &w, &h, &c)
//   tr_decode / tr_decode_png / tr_decode_tiff (path, out, out_len, &w,
//       &h, &c): TR_SMALL with w, h, c set when out_len is short
//   tr_prefetch(path)     queue a decode on the worker unless the path is
//                         cached or pending
//   tr_take(path, out, out_len, &w, &h, &c)  the path's cached entry
//                         (removed; waits while it is pending), or an
//                         inline decode when it was never queued or
//                         another take removed it first
//   tr_cache_size()       entries cached
//   tr_encode_png(path, buf, w, h, c)   PNG write now, c in 1, 3, 4
//   tr_write_async(path, buf, w, h, c)  copy buf and queue its write
//   tr_flush_writes()     wait for the queue to drain; the failed writes
//                         since the last flush
// and, for the Python binding:
//   tr_decode_owned / tr_take_owned (path, &data, &w, &h, &c): as
//       tr_decode / tr_take, into a buffer malloc'd here and handed to
//       the caller, who frees it with tr_free (no copy, no second pass)
//   tr_last_error(), tr_last_errno()
//   tr_decode_count(worker)  decodes run on the worker (1) or inline in
//                         tr_take (0) since the library loaded
//
// Nothing here touches the Python interpreter: ctypes releases its lock
// around every call, and the worker and writer threads never take it.

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <exception>
#include <map>
#include <memory>
#include <mutex>
#include <new>
#include <set>
#include <string>
#include <thread>
#include <vector>

#include "zlib_calls.h"

namespace {

constexpr int kOk = 0;
constexpr int kUnreadable = -1;   // TR_UNREADABLE
constexpr int kSmall = -2;        // TR_SMALL: the caller's buffer is short
constexpr int kUnsupported = -3;  // TR_UNSUPPORTED: PIL decodes it
constexpr uint64_t kMaxPixels = uint64_t(1) << 38;  // w * h the tier takes

// A decode that cannot go on: its status, the errno of a failed system
// call (0 for a format error) and the reason.
struct Fail {
  int status;
  int err;
  std::string what;
};

[[noreturn]] void unreadable(const std::string& what, int err = 0) {
  throw Fail{kUnreadable, err, what};
}

[[noreturn]] void unsupported(const std::string& what) {
  throw Fail{kUnsupported, 0, what};
}

struct FreeDeleter {
  void operator()(uint8_t* p) const { std::free(p); }
};
using Buffer = std::unique_ptr<uint8_t, FreeDeleter>;

// malloc, not new[]: the owned calls hand the buffer to the caller, who
// frees it through tr_free. Not zeroed: every byte is written.
Buffer allocate(size_t n) {
  auto* p = static_cast<uint8_t*>(std::malloc(n ? n : 1));
  if (!p) throw std::bad_alloc();
  return Buffer(p);
}

class File {
 public:
  explicit File(const char* path) : fd_(::open(path, O_RDONLY | O_CLOEXEC)) {
    if (fd_ < 0) unreadable(std::strerror(errno), errno);
    struct stat st;
    if (::fstat(fd_, &st) != 0) {
      const int err = errno;
      ::close(fd_);
      unreadable(std::strerror(err), err);
    }
    size_ = static_cast<uint64_t>(st.st_size);
  }
  ~File() { ::close(fd_); }
  File(const File&) = delete;
  File& operator=(const File&) = delete;

  uint64_t size() const { return size_; }

  // n bytes at off into dst; the file ending first is a truncation
  void read(uint64_t off, void* dst, uint64_t n, const char* what) const {
    if (off > size_ || n > size_ - off)
      unreadable(std::string("truncated ") + what);
    auto* p = static_cast<uint8_t*>(dst);
    while (n) {
      const ssize_t got = ::pread(fd_, p, n, static_cast<off_t>(off));
      if (got < 0) {
        if (errno == EINTR) continue;
        unreadable(std::strerror(errno), errno);
      }
      if (got == 0) unreadable(std::string("truncated ") + what);
      p += got;
      off += got;
      n -= got;
    }
  }

 private:
  int fd_;
  uint64_t size_ = 0;
};

uint16_t get16(const uint8_t* p, bool be) {
  return be ? uint16_t(p[0] << 8 | p[1]) : uint16_t(p[1] << 8 | p[0]);
}

uint32_t get32(const uint8_t* p, bool be) {
  return be ? uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 |
                  uint32_t(p[2]) << 8 | p[3]
            : uint32_t(p[3]) << 24 | uint32_t(p[2]) << 16 |
                  uint32_t(p[1]) << 8 | p[0];
}

void put32(uint8_t* p, uint32_t v) {  // big-endian, as PNG stores it
  p[0] = uint8_t(v >> 24);
  p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8);
  p[3] = uint8_t(v);
}

uint32_t crc(const uint8_t* p, uint64_t n) {
  unsigned long c = crc32(0, nullptr, 0);
  for (uint64_t done = 0; done < n;) {
    const unsigned int part =
        static_cast<unsigned int>(std::min<uint64_t>(n - done, 1u << 30));
    c = crc32(c, p + done, part);
    done += part;
  }
  return static_cast<uint32_t>(c);
}

// dst[0, want) from the zlib stream src[0, n). Data past want is ignored,
// as libtiff and libpng ignore it; a stream that ends before is corrupt.
void inflate(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t want,
             const char* what) {
  unsigned long got = want;
  const int rc = uncompress(dst, &got, src, n);
  if ((rc == zlib::kOk || rc == zlib::kBufError) && got == want) return;
  unreadable(std::string("corrupt Deflate stream in ") + what);
}

// -- TIFF ---------------------------------------------------------------------

enum : uint16_t {
  kWidth = 256, kLength = 257, kBits = 258, kCompression = 259,
  kPhotometric = 262, kFillOrder = 266, kStripOffsets = 273,
  kOrientation = 274, kSamples = 277, kRowsPerStrip = 278,
  kStripCounts = 279, kPlanar = 284, kPredictor = 317, kTileWidth = 322,
  kTileLength = 323, kTileOffsets = 324, kTileCounts = 325,
  kExtraSamples = 338, kSampleFormat = 339,
};

const std::set<uint16_t> kTiffTags = {
    kWidth, kLength, kBits, kCompression, kPhotometric, kFillOrder,
    kStripOffsets, kOrientation, kSamples, kRowsPerStrip, kStripCounts,
    kPlanar, kPredictor, kTileWidth, kTileLength, kTileOffsets, kTileCounts,
    kExtraSamples, kSampleFormat};

enum : uint32_t {
  kNone = 1, kLzw = 5, kDeflate = 8, kAdobeDeflate = 32946,
  kPackBits = 32773,
};

// A supported TIFF's layout: blocks (strips, or tiles) of bw x bh pixels
// at offsets[i], counts[i] bytes each, row-major.
struct Tiff {
  uint32_t w = 0, h = 0, spp = 0;
  uint32_t compression = kNone;
  bool predictor = false;  // horizontal differencing (predictor 2)
  bool tiled = false;
  uint32_t bw = 0, bh = 0;
  uint64_t across = 0, down = 0;
  std::vector<uint64_t> offsets, counts;
};

// bytes of one value of an integer TIFF type, 0 for the others
unsigned type_size(uint16_t type) {
  switch (type) {
    case 1: case 6: case 7: return 1;     // BYTE, SBYTE, UNDEFINED
    case 3: case 8: return 2;             // SHORT, SSHORT
    case 4: case 9: case 13: return 4;    // LONG, SLONG, IFD
    default: return 0;
  }
}

Tiff read_tiff(const File& f) {
  uint8_t hdr[8];
  f.read(0, hdr, sizeof hdr, "TIFF header");
  const bool be = hdr[0] == 'M';
  if (!((hdr[0] == 'I' && hdr[1] == 'I') || (hdr[0] == 'M' && hdr[1] == 'M')))
    unreadable("not a TIFF file");
  const uint16_t magic = get16(hdr + 2, be);
  if (magic == 43) unsupported("BigTIFF");
  if (magic != 42) unreadable("not a TIFF file");
  const uint32_t ifd = get32(hdr + 4, be);
  uint8_t nb[2];
  f.read(ifd, nb, 2, "TIFF directory");
  std::vector<uint8_t> entries(size_t(get16(nb, be)) * 12);
  f.read(uint64_t(ifd) + 2, entries.data(), entries.size(), "TIFF directory");

  std::map<uint16_t, std::vector<uint64_t>> tags;
  for (size_t at = 0; at < entries.size(); at += 12) {
    const uint8_t* e = entries.data() + at;
    const uint16_t tag = get16(e, be);
    if (!kTiffTags.count(tag)) continue;
    const unsigned size = type_size(get16(e + 2, be));
    if (!size) unsupported("TIFF tag " + std::to_string(tag) + " type");
    const uint64_t count = get32(e + 4, be);
    const uint64_t bytes = count * size;
    if (bytes > f.size()) unreadable("truncated TIFF tag");
    std::vector<uint8_t> raw(bytes);
    if (bytes <= 4)
      std::memcpy(raw.data(), e + 8, bytes);
    else
      f.read(get32(e + 8, be), raw.data(), bytes, "TIFF tag");
    std::vector<uint64_t>& v = tags[tag];
    v.resize(count);
    for (uint64_t j = 0; j < count; ++j)
      v[j] = size == 1 ? raw[j]
             : size == 2 ? get16(&raw[j * 2], be)
                         : get32(&raw[j * 4], be);
  }
  auto has = [&](uint16_t tag) {
    auto it = tags.find(tag);
    return it != tags.end() && !it->second.empty();
  };
  auto first = [&](uint16_t tag, uint64_t dflt) {
    return has(tag) ? tags[tag][0] : dflt;
  };
  auto all = [&](uint16_t tag, uint64_t want, uint64_t dflt) {
    if (!has(tag)) return dflt == want;
    for (uint64_t v : tags[tag])
      if (v != want) return false;
    return true;
  };

  Tiff t;
  t.w = static_cast<uint32_t>(first(kWidth, 0));
  t.h = static_cast<uint32_t>(first(kLength, 0));
  t.spp = static_cast<uint32_t>(first(kSamples, 1));
  if (!has(kPhotometric)) unsupported("no photometric interpretation");
  if (!all(kBits, 8, 1)) unsupported("samples not of 8 bits");
  if (!all(kSampleFormat, 1, 1)) unsupported("samples not unsigned");
  if (first(kOrientation, 1) != 1) unsupported("orientation not top-left");
  if (first(kFillOrder, 1) != 1) unsupported("LSB-first fill order");
  if (first(kPlanar, 1) != 1 && t.spp != 1) unsupported("separate planes");
  // the layouts whose PIL array is the stored samples: L, LA (ExtraSamples
  // 2), RGB, RGBA (none or 2); PIL premultiplies for 1 and drops 0's
  const uint64_t photometric = first(kPhotometric, 0);
  const std::vector<uint64_t> extra =
      has(kExtraSamples) ? tags[kExtraSamples] : std::vector<uint64_t>();
  const bool alpha = extra == std::vector<uint64_t>{2};
  const bool layout =
      (photometric == 1 && t.spp == 1 && extra.empty()) ||
      (photometric == 1 && t.spp == 2 && alpha) ||
      (photometric == 2 && t.spp == 3 && extra.empty()) ||
      (photometric == 2 && t.spp == 4 && (extra.empty() || alpha));
  if (!layout) unsupported("photometric and sample layout");
  t.compression = static_cast<uint32_t>(first(kCompression, kNone));
  if (t.compression != kNone && t.compression != kLzw &&
      t.compression != kDeflate && t.compression != kAdobeDeflate &&
      t.compression != kPackBits)
    unsupported("compression " + std::to_string(t.compression));
  if (t.compression == kLzw || t.compression == kDeflate ||
      t.compression == kAdobeDeflate) {
    const uint64_t predictor = first(kPredictor, 1);
    if (predictor != 1 && predictor != 2) unsupported("predictor");
    t.predictor = predictor == 2;
  }
  if (!t.w || !t.h) unreadable("empty TIFF image");
  if (uint64_t(t.w) * t.h > kMaxPixels) unsupported("TIFF too large");

  std::vector<uint64_t> no;
  if (has(kTileWidth) || has(kTileOffsets)) {
    t.tiled = true;
    t.bw = static_cast<uint32_t>(first(kTileWidth, 0));
    t.bh = static_cast<uint32_t>(first(kTileLength, 0));
    if (!t.bw || !t.bh) unreadable("no TIFF tile size");
    if (uint64_t(t.bw) * t.bh > kMaxPixels) unsupported("TIFF tile too large");
    t.offsets = has(kTileOffsets) ? tags[kTileOffsets] : no;
    t.counts = has(kTileCounts) ? tags[kTileCounts] : no;
  } else {
    if (!has(kStripCounts)) unsupported("no strip byte counts");
    const uint64_t rps = first(kRowsPerStrip, 0xFFFFFFFFu);
    t.bw = t.w;
    t.bh = static_cast<uint32_t>(rps == 0 || rps > t.h ? t.h : rps);
    t.offsets = has(kStripOffsets) ? tags[kStripOffsets] : no;
    t.counts = tags[kStripCounts];
  }
  t.across = (uint64_t(t.w) + t.bw - 1) / t.bw;
  t.down = (uint64_t(t.h) + t.bh - 1) / t.bh;
  if (t.offsets.size() < t.across * t.down ||
      t.counts.size() < t.across * t.down)
    unreadable(t.tiled ? "too few TIFF tiles" : "too few TIFF strips");
  return t;
}

// TIFF LZW (MSB-first codes of 9 to 12 bits, one code early, as libtiff
// writes and reads them) from src[0, n) into dst[0, want).
void lzw_decode(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t want) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1))
    unsupported("old-style (LSB-first) LZW");
  constexpr int kClear = 256, kEnd = 257, kFirst = 258, kMax = 4096;
  uint16_t prefix[kMax], length[kMax];
  uint8_t suffix[kMax], head[kMax];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0;
    length[i] = 1;
    suffix[i] = head[i] = uint8_t(i);
  }
  int width = 9, next = kFirst, prev = -1, bits = 0;
  uint32_t buf = 0;
  uint64_t pos = 0, out = 0;
  while (out < want) {
    while (bits < width) {
      if (pos >= n) unreadable("LZW data ends early");
      buf = buf << 8 | src[pos++];
      bits += 8;
    }
    bits -= width;
    const int code = (buf >> bits) & ((1u << width) - 1);
    if (code == kEnd) break;
    if (code == kClear) {
      width = 9;
      next = kFirst;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code > 255) unreadable("corrupt LZW data");
      dst[out++] = uint8_t(code);
      prev = code;
      continue;
    }
    if (code > next || (code == next && next >= kMax))
      unreadable("corrupt LZW data");
    if (next < kMax) {  // the new string: prev's and code's first byte
      prefix[next] = uint16_t(prev);
      suffix[next] = code == next ? head[prev] : head[code];
      head[next] = head[prev];
      length[next] = uint16_t(length[prev] + 1);
      if (++next >= (1 << width) - 1 && width < 12) ++width;
    }
    // code's string, cut at want, written back to front
    const uint64_t len = length[code];
    const uint64_t fit = std::min(len, want - out);
    int c = code;
    for (uint64_t k = len; k > fit; --k) c = prefix[c];
    for (uint64_t k = fit; k > 0; --k) {
      dst[out + k - 1] = suffix[c];
      c = prefix[c];
    }
    out += fit;
    prev = code;
  }
  if (out < want) unreadable("LZW data ends early");
}

// PackBits runs from src[0, n) into dst[0, want).
void packbits_decode(const uint8_t* src, uint64_t n, uint8_t* dst,
                     uint64_t want) {
  uint64_t pos = 0, out = 0;
  while (out < want) {
    if (pos >= n) unreadable("PackBits data ends early");
    const int head = int8_t(src[pos++]);
    if (head == -128) continue;
    if (head < 0) {
      if (pos >= n) unreadable("PackBits data ends early");
      const uint64_t k = std::min<uint64_t>(1 - head, want - out);
      std::memset(dst + out, src[pos++], k);
      out += k;
    } else {
      const uint64_t k = uint64_t(head) + 1;
      if (n - pos < k) unreadable("PackBits data ends early");
      const uint64_t fit = std::min(k, want - out);
      std::memcpy(dst + out, src + pos, fit);
      pos += k;
      out += fit;
    }
  }
}

// horizontal differencing undone, row by row, sample by sample
void undo_predictor(uint8_t* p, uint64_t rows, uint64_t rowbytes,
                    uint32_t spp) {
  for (uint64_t r = 0; r < rows; ++r) {
    uint8_t* row = p + r * rowbytes;
    for (uint64_t i = spp; i < rowbytes; ++i)
      row[i] = uint8_t(row[i] + row[i - spp]);
  }
}

void decode_tiff(const File& f, const Tiff& t, uint8_t* out) {
  const uint64_t rowbytes = uint64_t(t.w) * t.spp;
  const uint64_t brow = uint64_t(t.bw) * t.spp;  // a block's row
  const uint64_t blocks = t.across * t.down;
  auto rows_of = [&](uint64_t i) {  // a strip's rows; the last may be short
    return std::min<uint64_t>(t.bh, t.h - (i / t.across) * t.bh);
  };
  if (!t.tiled && t.compression == kNone) {
    // strips read straight into place, neighbours in one read
    for (uint64_t i = 0; i < blocks; ++i)
      if (t.counts[i] < rows_of(i) * rowbytes) unreadable("short TIFF strip");
    for (uint64_t i = 0; i < blocks;) {
      uint64_t bytes = rows_of(i) * rowbytes, e = i + 1;
      while (e < blocks && t.offsets[e] == t.offsets[i] + bytes)
        bytes += rows_of(e++) * rowbytes;
      f.read(t.offsets[i], out + i * t.bh * rowbytes, bytes, "TIFF strip");
      i = e;
    }
    return;
  }
  std::vector<uint8_t> raw, tile(t.tiled ? brow * t.bh : 0);
  for (uint64_t i = 0; i < blocks; ++i) {
    const uint64_t y0 = (i / t.across) * t.bh, x0 = (i % t.across) * t.bw;
    const uint64_t rows = std::min<uint64_t>(t.bh, t.h - y0);
    const uint64_t want = t.tiled ? brow * t.bh : rows * rowbytes;
    uint8_t* dst = t.tiled ? tile.data() : out + y0 * rowbytes;
    if (t.compression == kNone) {
      if (t.counts[i] < want) unreadable("short TIFF tile");
      f.read(t.offsets[i], dst, want, "TIFF tile");
    } else {
      if (t.counts[i] > f.size()) unreadable("truncated TIFF block");
      raw.resize(t.counts[i]);
      f.read(t.offsets[i], raw.data(), raw.size(), "TIFF block");
      if (t.compression == kLzw)
        lzw_decode(raw.data(), raw.size(), dst, want);
      else if (t.compression == kPackBits)
        packbits_decode(raw.data(), raw.size(), dst, want);
      else
        inflate(raw.data(), raw.size(), dst, want, "TIFF block");
      if (t.predictor) undo_predictor(dst, want / brow, brow, t.spp);
    }
    if (t.tiled) {
      const uint64_t cols = std::min<uint64_t>(t.bw, t.w - x0) * t.spp;
      for (uint64_t r = 0; r < rows; ++r)
        std::memcpy(out + (y0 + r) * rowbytes + x0 * t.spp,
                    tile.data() + r * brow, cols);
    }
  }
}

// -- PNG ----------------------------------------------------------------------

const uint8_t kPngSignature[8] = {137, 80, 78, 71, 13, 10, 26, 10};

struct Png {
  uint32_t w = 0, h = 0, c = 0;
};

bool is_type(const uint8_t* type, const char* name) {
  return std::memcmp(type, name, 4) == 0;
}

std::string type_name(const uint8_t* type) {
  return std::string(reinterpret_cast<const char*>(type), 4);
}

// a critical chunk (upper-case first letter) that this decoder does not
// know; PLTE is one it skips (a suggested palette of a truecolour image)
bool unknown_critical(const uint8_t* type) {
  return type[0] >= 'A' && type[0] <= 'Z' && !is_type(type, "IHDR") &&
         !is_type(type, "PLTE") && !is_type(type, "IDAT") &&
         !is_type(type, "IEND");
}

// IHDR's 13 bytes: the image's size, or why the tier does not carry it
Png png_header(const uint8_t* d) {
  Png p;
  p.w = get32(d, true);
  p.h = get32(d + 4, true);
  const int depth = d[8], color = d[9];
  if (!p.w || !p.h || p.w > 0x7FFFFFFFu || p.h > 0x7FFFFFFFu)
    unreadable("bad PNG image size");
  if (d[10] != 0 || d[11] != 0 || d[12] > 1) unreadable("bad PNG header");
  if (depth != 1 && depth != 2 && depth != 4 && depth != 8 && depth != 16)
    unreadable("bad PNG bit depth");
  switch (color) {
    case 0: p.c = 1; break;
    case 2: p.c = 3; break;
    case 3: unsupported("palette PNG");
    case 4: p.c = 2; break;
    case 6: p.c = 4; break;
    default: unreadable("bad PNG colour type");
  }
  if (depth != 8) unsupported("PNG of " + std::to_string(depth) + " bits");
  if (d[12]) unsupported("interlaced PNG");
  if (uint64_t(p.w) * p.h > kMaxPixels) unsupported("PNG too large");
  return p;
}

// the header and the chunks before the first IDAT, read chunk by chunk:
// the size, or why the tier does not carry the file (tRNS)
Png png_probe(const File& f) {
  uint8_t head[33];
  f.read(0, head, sizeof head, "PNG header");
  if (std::memcmp(head, kPngSignature, 8) != 0) unreadable("not a PNG file");
  if (get32(head + 8, true) != 13 || !is_type(head + 12, "IHDR"))
    unreadable("no IHDR chunk first");
  if (crc(head + 12, 17) != get32(head + 29, true))
    unreadable("bad CRC in IHDR chunk");
  const Png p = png_header(head + 16);
  for (uint64_t pos = sizeof head;;) {
    uint8_t chunk[8];
    f.read(pos, chunk, sizeof chunk, "PNG chunk");
    const uint8_t* type = chunk + 4;
    if (is_type(type, "IDAT")) return p;
    if (is_type(type, "IEND")) unreadable("no PNG image data");
    if (is_type(type, "tRNS")) unsupported("PNG with tRNS");
    if (unknown_critical(type)) unsupported("PNG chunk " + type_name(type));
    pos += 12 + uint64_t(get32(chunk, true));
  }
}

void unfilter(const uint8_t* in, uint8_t* out, const Png& p) {
  const uint64_t rb = uint64_t(p.w) * p.c;
  const unsigned bpp = p.c;
  std::vector<uint8_t> zero(rb, 0);
  const uint8_t* up = zero.data();
  for (uint64_t r = 0; r < p.h; ++r, in += rb + 1) {
    const uint8_t filter = in[0];
    const uint8_t* x = in + 1;
    uint8_t* o = out + r * rb;
    switch (filter) {
      case 0:
        std::memcpy(o, x, rb);
        break;
      case 1:
        std::memcpy(o, x, bpp);
        for (uint64_t i = bpp; i < rb; ++i) o[i] = uint8_t(x[i] + o[i - bpp]);
        break;
      case 2:
        for (uint64_t i = 0; i < rb; ++i) o[i] = uint8_t(x[i] + up[i]);
        break;
      case 3:
        for (uint64_t i = 0; i < bpp; ++i) o[i] = uint8_t(x[i] + (up[i] >> 1));
        for (uint64_t i = bpp; i < rb; ++i)
          o[i] = uint8_t(x[i] + ((o[i - bpp] + up[i]) >> 1));
        break;
      case 4:
        for (uint64_t i = 0; i < bpp; ++i) o[i] = uint8_t(x[i] + up[i]);
        for (uint64_t i = bpp; i < rb; ++i) {
          const int a = o[i - bpp], b = up[i], c = up[i - bpp];
          const int pa = std::abs(b - c), pb = std::abs(a - c),
                    pc = std::abs(a + b - 2 * c);
          o[i] = uint8_t(x[i] + (pa <= pb && pa <= pc ? a : pb <= pc ? b : c));
        }
        break;
      default:
        unreadable("bad PNG row filter " + std::to_string(filter));
    }
    up = o;
  }
}

// The whole file is read, every chunk's CRC checked and the IDAT data
// joined in place (each IDAT's bytes moved down over the chunk framing
// before it), inflated, then unfiltered into out.
void decode_png(const File& f, const Png& p, uint8_t* out) {
  const uint64_t n = f.size();
  Buffer file = allocate(n);
  uint8_t* b = file.get();
  f.read(0, b, n, "PNG file");
  uint64_t pos = 33, idat = 0, joined = 0;  // IDAT data at [idat, joined)
  bool in_idat = false, after_idat = false;
  for (;;) {
    if (n - pos < 12) unreadable("truncated PNG file");
    const uint64_t len = get32(b + pos, true);
    if (len > 0x7FFFFFFFu || n - pos - 12 < len)
      unreadable("truncated PNG file");
    const uint8_t* type = b + pos + 4;
    if (crc(type, len + 4) != get32(type + 4 + len, true))
      unreadable("bad CRC in " + type_name(type) + " chunk");
    if (is_type(type, "IDAT")) {
      if (after_idat) unreadable("IDAT chunks apart");
      if (!in_idat) idat = joined = pos + 8;
      in_idat = true;
      std::memmove(b + joined, type + 4, len);
      joined += len;
    } else {
      after_idat = in_idat;
      if (is_type(type, "IEND")) break;
      if (is_type(type, "tRNS")) unsupported("PNG with tRNS");
      if (unknown_critical(type)) unsupported("PNG chunk " + type_name(type));
    }
    pos += 12 + len;
  }
  if (!in_idat) unreadable("no PNG image data");
  const uint64_t filtered_size = (uint64_t(p.w) * p.c + 1) * p.h;
  Buffer filtered = allocate(filtered_size);
  inflate(b + idat, joined - idat, filtered.get(), filtered_size,
          "PNG image data");
  file.reset();
  unfilter(filtered.get(), out, p);
}

// -- dispatch -------------------------------------------------------------------

enum class Format { kAny, kPng, kTiff };

// the format of f's first bytes, when the caller did not name one
Format sniff(const File& f, Format only) {
  if (only != Format::kAny) return only;
  uint8_t m[8] = {0};
  const uint64_t n = std::min<uint64_t>(sizeof m, f.size());
  f.read(0, m, n, "header");
  if (n >= 8 && std::memcmp(m, kPngSignature, 8) == 0) return Format::kPng;
  if (n >= 4 && (std::memcmp(m, "II*\0", 4) == 0 ||
                 std::memcmp(m, "MM\0*", 4) == 0))
    return Format::kTiff;
  if (n >= 4 && (std::memcmp(m, "II+\0", 4) == 0 ||
                 std::memcmp(m, "MM\0+", 4) == 0))
    unsupported("BigTIFF");
  if ((n >= 3 && m[0] == 0xFF && m[1] == 0xD8 && m[2] == 0xFF) ||
      (n >= 4 && (std::memcmp(m, "GIF8", 4) == 0 ||
                  std::memcmp(m, "RIFF", 4) == 0)) ||
      (n >= 2 && std::memcmp(m, "BM", 2) == 0))
    unsupported("neither PNG nor TIFF");
  unreadable("not a PNG or TIFF file");
}

// A file's size and how to decode it, read from its header only.
struct Probe {
  uint32_t w = 0, h = 0, c = 0;
  Format format = Format::kAny;
  Png png;
  Tiff tiff;
  uint64_t bytes() const { return uint64_t(w) * h * c; }
};

Probe probe(const File& f, Format only) {
  Probe p;
  p.format = sniff(f, only);
  if (p.format == Format::kPng) {
    p.png = png_probe(f);
    p.w = p.png.w, p.h = p.png.h, p.c = p.png.c;
  } else {
    p.tiff = read_tiff(f);
    p.w = p.tiff.w, p.h = p.tiff.h, p.c = p.tiff.spp;
  }
  return p;
}

void decode(const File& f, const Probe& p, uint8_t* out) {
  if (p.format == Format::kPng)
    decode_png(f, p.png, out);
  else
    decode_tiff(f, p.tiff, out);
}

// The outcome of one decode; what the cache holds.
struct Image {
  int status = kUnreadable;
  int err = 0;
  std::string what;
  uint32_t w = 0, h = 0, c = 0;
  Buffer data;
};

// Runs body, turning a Fail (or running out of memory) into a status.
template <typename F>
int guarded(F&& body, int* err, std::string* what) {
  try {
    body();
    return kOk;
  } catch (const Fail& e) {
    *err = e.err;
    *what = e.what;
    return e.status;
  } catch (const std::bad_alloc&) {
    *err = ENOMEM;
    *what = std::strerror(ENOMEM);
    return kUnreadable;
  } catch (const std::exception& e) {
    *err = 0;
    *what = e.what();
    return kUnreadable;
  }
}

Image decode_file(const char* path, Format only = Format::kAny) {
  Image img;
  img.status = guarded(
      [&] {
        File f(path);
        const Probe p = probe(f, only);
        Buffer data = allocate(p.bytes());
        decode(f, p, data.get());
        img.w = p.w, img.h = p.h, img.c = p.c;
        img.data = std::move(data);
      },
      &img.err, &img.what);
  return img;
}

thread_local int t_errno = 0;
thread_local std::string t_error;

// A status for the calling thread, with its reason kept for
// tr_last_error / tr_last_errno.
int report(int status, int err, const std::string& what) {
  t_errno = status == kOk ? 0 : err;
  t_error = status == kOk ? std::string() : what;
  return status;
}

std::atomic<int64_t> g_worker_decodes{0}, g_inline_decodes{0};

class Prefetcher {
 public:
  Prefetcher() : worker_(&Prefetcher::run, this) {}

  void prefetch(const std::string& path) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (cache_.count(path) || pending_.count(path)) return;
      pending_.insert(path);
      queue_.push_back(path);
    }
    cv_.notify_one();
  }

  Image take(const std::string& path) {
    std::unique_lock<std::mutex> lk(mu_);
    if (!cache_.count(path) && !pending_.count(path)) {
      lk.unlock();
      return inline_decode(path);  // never queued: decode here
    }
    // wait for "cached or no longer pending": another take of the same
    // path may remove the entry first, and then this one decodes inline
    done_.wait(lk, [&] { return cache_.count(path) || !pending_.count(path); });
    auto it = cache_.find(path);
    if (it == cache_.end()) {
      lk.unlock();
      return inline_decode(path);
    }
    Image img = std::move(it->second);
    cache_.erase(it);
    return img;
  }

  size_t size() {
    std::lock_guard<std::mutex> lk(mu_);
    return cache_.size();
  }

 private:
  static Image inline_decode(const std::string& path) {
    ++g_inline_decodes;
    return decode_file(path.c_str());
  }

  void run() {
    for (;;) {
      std::string path;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return !queue_.empty(); });
        path = std::move(queue_.front());
        queue_.pop_front();
      }
      ++g_worker_decodes;
      Image img = decode_file(path.c_str());
      {
        std::lock_guard<std::mutex> lk(mu_);
        cache_[path] = std::move(img);
        pending_.erase(path);
      }
      done_.notify_all();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_, done_;
  std::deque<std::string> queue_;
  std::map<std::string, Image> cache_;
  std::set<std::string> pending_;
  std::thread worker_;
};

Prefetcher& prefetcher() {
  static Prefetcher* p = new Prefetcher();  // never destroyed: its thread runs on
  return *p;
}

// -- PNG writing ------------------------------------------------------------------

constexpr uint64_t kIdatBytes = 1 << 20;  // IDAT chunks of 1 MiB

// one chunk: length, type, data, CRC of type and data (no allocation, so
// nothing throws between fopen and fclose)
bool write_chunk(FILE* fp, const char* type, const uint8_t* data,
                 uint32_t len) {
  uint8_t head[8], tail[4];
  put32(head, len);
  std::memcpy(head + 4, type, 4);
  unsigned long c = crc32(0, head + 4, 4);
  if (len) c = crc32(c, data, len);
  put32(tail, static_cast<uint32_t>(c));
  return std::fwrite(head, 1, 8, fp) == 8 &&
         (!len || std::fwrite(data, 1, len, fp) == len) &&
         std::fwrite(tail, 1, 4, fp) == 4;
}

// (h, w, c) uint8 as an 8-bit PNG (gray, RGB or RGBA): every row through
// the Sub filter (flat masks become runs of zeros), zlib level 1, as the
// JAX writer's libpng setting.
bool encode_png(const char* path, const uint8_t* buf, uint32_t w, uint32_t h,
                uint32_t c) {
  if ((c != 1 && c != 3 && c != 4) || !w || !h) return false;
  try {
    const uint64_t rb = uint64_t(w) * c, size = (rb + 1) * h;
    Buffer filtered = allocate(size);
    for (uint64_t r = 0; r < h; ++r) {
      const uint8_t* x = buf + r * rb;
      uint8_t* o = filtered.get() + r * (rb + 1);
      o[0] = 1;
      std::memcpy(o + 1, x, c);
      for (uint64_t i = c; i < rb; ++i) o[1 + i] = uint8_t(x[i] - x[i - c]);
    }
    unsigned long zlen = compressBound(size);
    Buffer z = allocate(zlen);
    if (compress2(z.get(), &zlen, filtered.get(), size, 1) != zlib::kOk)
      return false;
    filtered.reset();
    uint8_t ihdr[13] = {0};
    put32(ihdr, w);
    put32(ihdr + 4, h);
    ihdr[8] = 8;
    ihdr[9] = c == 1 ? 0 : c == 3 ? 2 : 6;
    FILE* fp = std::fopen(path, "wb");
    if (!fp) return false;
    bool wrote = std::fwrite(kPngSignature, 1, 8, fp) == 8 &&
                 write_chunk(fp, "IHDR", ihdr, sizeof ihdr);
    for (uint64_t at = 0; wrote && at < zlen; at += kIdatBytes)
      wrote = write_chunk(fp, "IDAT", z.get() + at, static_cast<uint32_t>(
                              std::min<uint64_t>(kIdatBytes, zlen - at)));
    wrote = wrote && write_chunk(fp, "IEND", nullptr, 0);
    return (std::fclose(fp) == 0) && wrote;
  } catch (const std::exception&) {  // out of memory: the write failed
    return false;
  }
}

struct WriteJob {
  std::string path;
  std::vector<uint8_t> data;
  uint32_t w = 0, h = 0, c = 0;
};

class Writer {
 public:
  Writer() : worker_(&Writer::run, this) {}

  void enqueue(WriteJob job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      queue_.push_back(std::move(job));
      ++outstanding_;
    }
    cv_.notify_one();
  }

  int64_t flush() {
    std::unique_lock<std::mutex> lk(mu_);
    done_.wait(lk, [&] { return outstanding_ == 0; });
    const int64_t failed = failures_;
    failures_ = 0;
    return failed;
  }

 private:
  void run() {
    for (;;) {
      WriteJob job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return !queue_.empty(); });
        job = std::move(queue_.front());
        queue_.pop_front();
      }
      const bool ok =
          encode_png(job.path.c_str(), job.data.data(), job.w, job.h, job.c);
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (!ok) ++failures_;
        --outstanding_;
      }
      done_.notify_all();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_, done_;
  std::deque<WriteJob> queue_;
  int64_t outstanding_ = 0;
  int64_t failures_ = 0;
  std::thread worker_;
};

Writer& writer() {
  static Writer* w = new Writer();  // never destroyed: its thread runs on
  return *w;
}

int info(const char* path, Format only, uint32_t* w, uint32_t* h,
         uint32_t* c) {
  int err = 0;
  std::string what;
  const int status = guarded(
      [&] {
        File f(path);
        const Probe p = probe(f, only);
        *w = p.w, *h = p.h, *c = p.c;
      },
      &err, &what);
  return report(status, err, what);
}

// decode straight into the caller's buffer after reading the header
int decode_into(const char* path, Format only, uint8_t* out, int64_t out_len,
                uint32_t* w, uint32_t* h, uint32_t* c) {
  int err = 0;
  std::string what;
  bool small = false;
  const int status = guarded(
      [&] {
        File f(path);
        const Probe p = probe(f, only);
        *w = p.w, *h = p.h, *c = p.c;
        if (out_len < 0 || uint64_t(out_len) < p.bytes()) {
          small = true;
          return;
        }
        decode(f, p, out);
      },
      &err, &what);
  if (status == kOk && small) return report(kSmall, 0, "buffer too small");
  return report(status, err, what);
}

int copy_out(const Image& img, uint8_t* out, int64_t out_len, uint32_t* w,
             uint32_t* h, uint32_t* c) {
  if (img.status != kOk) return report(img.status, img.err, img.what);
  *w = img.w, *h = img.h, *c = img.c;
  const uint64_t need = uint64_t(img.w) * img.h * img.c;
  if (out_len < 0 || uint64_t(out_len) < need)
    return report(kSmall, 0, "buffer too small");
  std::memcpy(out, img.data.get(), need);
  return report(kOk, 0, "");
}

int hand_over(Image img, uint8_t** data, uint32_t* w, uint32_t* h,
              uint32_t* c) {
  if (img.status != kOk) return report(img.status, img.err, img.what);
  *w = img.w, *h = img.h, *c = img.c;
  *data = img.data.release();
  return report(kOk, 0, "");
}

}  // namespace

extern "C" {

int tr_info(const char* path, uint32_t* w, uint32_t* h, uint32_t* c) {
  return info(path, Format::kAny, w, h, c);
}

int tr_png_info(const char* path, uint32_t* w, uint32_t* h, uint32_t* c) {
  return info(path, Format::kPng, w, h, c);
}

int tr_tiff_info(const char* path, uint32_t* w, uint32_t* h, uint32_t* c) {
  return info(path, Format::kTiff, w, h, c);
}

int tr_decode(const char* path, uint8_t* out, int64_t out_len, uint32_t* w,
              uint32_t* h, uint32_t* c) {
  return decode_into(path, Format::kAny, out, out_len, w, h, c);
}

int tr_decode_png(const char* path, uint8_t* out, int64_t out_len,
                  uint32_t* w, uint32_t* h, uint32_t* c) {
  return decode_into(path, Format::kPng, out, out_len, w, h, c);
}

int tr_decode_tiff(const char* path, uint8_t* out, int64_t out_len,
                   uint32_t* w, uint32_t* h, uint32_t* c) {
  return decode_into(path, Format::kTiff, out, out_len, w, h, c);
}

void tr_prefetch(const char* path) { prefetcher().prefetch(path); }

int tr_take(const char* path, uint8_t* out, int64_t out_len, uint32_t* w,
            uint32_t* h, uint32_t* c) {
  return copy_out(prefetcher().take(path), out, out_len, w, h, c);
}

int64_t tr_cache_size() { return static_cast<int64_t>(prefetcher().size()); }

int tr_decode_owned(const char* path, uint8_t** data, uint32_t* w,
                    uint32_t* h, uint32_t* c) {
  return hand_over(decode_file(path), data, w, h, c);
}

int tr_take_owned(const char* path, uint8_t** data, uint32_t* w, uint32_t* h,
                  uint32_t* c) {
  return hand_over(prefetcher().take(path), data, w, h, c);
}

void tr_free(uint8_t* data) { std::free(data); }

const char* tr_last_error() { return t_error.c_str(); }

int tr_last_errno() { return t_errno; }

int64_t tr_decode_count(int worker) {
  return worker ? g_worker_decodes.load() : g_inline_decodes.load();
}

int tr_encode_png(const char* path, const uint8_t* buf, uint32_t w,
                  uint32_t h, uint32_t c) {
  return encode_png(path, buf, w, h, c) ? kOk : kUnreadable;
}

void tr_write_async(const char* path, const uint8_t* buf, uint32_t w,
                    uint32_t h, uint32_t c) {
  WriteJob job;
  job.path = path;
  job.data.assign(buf, buf + uint64_t(w) * h * c);
  job.w = w, job.h = h, job.c = c;
  writer().enqueue(std::move(job));
}

int64_t tr_flush_writes() { return writer().flush(); }

}  // extern "C"
