"""The port's C++ native library: CRC32-C and the GF(2^8) SIMD host codec."""
