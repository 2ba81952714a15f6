// Path 4 of the bilateral kernel at radius 1 (k = 3):
// csrc/bilateral_circle.cuh's instantiations, self and joint, 1 and 2 rows a
// thread, in a file of their own.

#include "bilateral_circle.cuh"

int vip_bilateral::launch_circle_r1(const Launch& a) { return launch_circle<1>(a); }
