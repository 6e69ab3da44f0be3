// flash_decode's tensor-core arm at head dim 256 (flash_decode_tc.cuh): one source a head dim.

#include "flash_decode_tc.cuh"

namespace fd {
FD_TC_ENTRIES(256)
}  // namespace fd
