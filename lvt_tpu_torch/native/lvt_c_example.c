/* Example C program on the C ABI (lvt_c.h): tracks n_frames stereo pairs
 * of raw 8-bit frames (<dir>/left_<i>.raw, <dir>/right_<i>.raw, n_rows x
 * n_cols each) and prints the status before, after each frame and after
 * lvt_reset, and each pose as "pose R00 .. R22 t0 t1 t2" (%.9g); lvt_tpu's
 * C driver of tests/test_c_abi.py with the frame size on the command line.
 *
 *   gcc -O1 -o lvt_c_example lvt_c_example.c -I lvt_tpu_torch/native \
 *       -L build/lvt_tpu_torch -llvt_c_torch -Wl,-rpath,build/lvt_tpu_torch
 *   PYTHONPATH=. LVT_TPU_TORCH_DEVICE=cuda \
 *       ./lvt_c_example vo_config.yaml frames_dir n_frames n_rows n_cols
 *
 * Exit codes: 0 done, 1 usage, 2 a missing frame, 3 a short frame, 4
 * lvt_create returned NULL. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "lvt_c.h"

static unsigned char *read_raw(const char *path, int n) {
    FILE *f = fopen(path, "rb");
    if (!f) { fprintf(stderr, "missing %s\n", path); exit(2); }
    unsigned char *buf = malloc(n);
    if (fread(buf, 1, n, f) != (size_t)n) { exit(3); }
    fclose(f);
    return buf;
}

int main(int argc, char **argv) {
    if (argc != 6) {
        fprintf(stderr, "usage: %s cfg dir n_frames n_rows n_cols\n", argv[0]);
        return 1;
    }
    const char *cfg = argv[1], *dir = argv[2];
    int n_frames = atoi(argv[3]), h = atoi(argv[4]), w = atoi(argv[5]);
    lvt_handle vo = lvt_create(cfg, 1 /* STEREO */);
    if (!vo) { fprintf(stderr, "create failed\n"); return 4; }
    printf("status %d\n", lvt_get_status(vo));
    double R[3][3], t[3];
    char path[4096];
    for (int i = 0; i < n_frames; i++) {
        snprintf(path, sizeof path, "%s/left_%d.raw", dir, i);
        unsigned char *l = read_raw(path, h * w);
        snprintf(path, sizeof path, "%s/right_%d.raw", dir, i);
        unsigned char *r = read_raw(path, h * w);
        lvt_track(vo, l, r, h, w, R, t);
        printf("status %d\n", lvt_get_status(vo));
        printf("pose %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g\n",
               R[0][0], R[0][1], R[0][2], R[1][0], R[1][1], R[1][2],
               R[2][0], R[2][1], R[2][2], t[0], t[1], t[2]);
        free(l); free(r);
    }
    lvt_reset(vo);
    printf("status %d\n", lvt_get_status(vo));
    lvt_destroy(vo);
    printf("done\n");
    return 0;
}
