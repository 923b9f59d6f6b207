// Host build of the ORB detection stages of orb_detect.cuh, the code the
// kernels of orb_detect.cu run: one thread a block, each cell's stages in
// order, one cell and one level after another. Built with the host C++
// compiler; used by the CPU tests, which hold it against
// orb.py::detect_levels_plain bit for bit where there is no card. The entry
// point takes the kernels' arguments without the stream and returns 0.
#include <vector>

#include "orb_detect.cuh"

extern "C" int orb_detect_levels_host(const OrbDetectArgs* a) {
  static orb_detect::CellState s;
  for (int l = 0; l < a->n_levels; ++l) {
    for (int cell = 0; cell < a->level[l].ncx * a->level[l].ncy; ++cell) {
      s.n_pos = 0;
      orb_detect::cell_tile(*a, l, cell, s, 0, 1);
      orb_detect::cell_response(*a, l, cell, s, 0, 1);
      orb_detect::cell_suppress(*a, l, cell, s, 0, 1);
      orb_detect::cell_rank(*a, s, 0, 1);
      orb_detect::cell_fit(*a, l, cell, s, 0, 1);
    }
  }
  std::vector<unsigned long long> keys(a->pick_keys);
  for (int l = 0; l < a->n_levels; ++l) {
    orb_detect::pick_level(*a, l, keys.data(), 0, 1);
  }
  return 0;
}
