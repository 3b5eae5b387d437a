// The four buffer calls of zlib's C ABI that tile_reader.cpp takes from
// the system's libz.so.1 (linked as -l:libz.so.1), declared here so that
// the build needs no zlib.h. Their signatures have not changed across
// zlib 1.x: Bytef is unsigned char, uLong and uLongf unsigned long, uInt
// unsigned int.
#pragma once

extern "C" {

// Inflates the zlib stream source[0, source_len) into dest, whose room is
// *dest_len bytes on entry; *dest_len is the bytes written on return.
int uncompress(unsigned char* dest, unsigned long* dest_len,
               const unsigned char* source, unsigned long source_len);

// Deflates source into a zlib stream at level (0-9) in dest.
int compress2(unsigned char* dest, unsigned long* dest_len,
              const unsigned char* source, unsigned long source_len,
              int level);

// The most bytes compress2 can write for source_len input bytes.
unsigned long compressBound(unsigned long source_len);

// The CRC-32 of buf[0, len) continued from crc (0 to start).
unsigned long crc32(unsigned long crc, const unsigned char* buf,
                    unsigned int len);

}  // extern "C"

namespace zlib {
constexpr int kOk = 0;
constexpr int kBufError = -5;  // dest full before the stream ended
}  // namespace zlib
