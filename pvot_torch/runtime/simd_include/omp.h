/* An empty stand-in for <omp.h> in the -fopenmp-simd build of libpvot.cpp
   (pvot_torch/runtime/native.py): the source calls no omp_ function, and
   this directory is searched after the system's headers (-idirafter), so a
   compiler's own omp.h wins wherever it has one. */
