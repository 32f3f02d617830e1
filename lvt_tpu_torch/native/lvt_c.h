/* C interface for the lvt_tpu visual odometry framework.
 *
 * Drop-in equivalent of the reference's C ABI (lvt/src/lvt_c.h:55-62):
 * same five entry points, same signatures, same handle/status semantics,
 * so a C/C++ integration of the reference can switch by relinking against
 * liblvt_c.so. The implementation embeds CPython and drives the JAX/TPU
 * pipeline through lvt_tpu.capi.
 *
 * Requirements on the host process environment:
 *   - LVT_PYTHON or VIRTUAL_ENV may point at the python (venv) to embed;
 *     otherwise the build-time interpreter is used.
 *   - PYTHONPATH must make the `lvt_tpu` package importable.
 */
#ifndef LVT_TPU_C_INTERFACE_H
#define LVT_TPU_C_INTERFACE_H

#if defined(__GNUC__)
#define LVT_API __attribute__((visibility("default")))
#else
#define LVT_API
#endif

#ifdef __cplusplus
extern "C" {
#endif

typedef void *lvt_handle;

/* Create a VO system from a YAML config file.
 * sensor_type: 1 = STEREO, 2 = RGBD. Returns NULL on failure. */
LVT_API lvt_handle lvt_create(const char *config_file_name, int sensor_type);

/* Destroy a handle returned by lvt_create. */
LVT_API void lvt_destroy(lvt_handle vo_system);

/* Track one frame of n_rows x n_cols 8-bit grayscale images (stereo:
 * left/right; RGB-D: gray/depth). Writes the estimated pose into R
 * (row-major rotation) and t (position). */
LVT_API void lvt_track(lvt_handle vo_system, unsigned char *left_img,
                       unsigned char *right_img, int n_rows, int n_cols,
                       double R[3][3], double t[3]);

/* Tracking with caller-supplied corner locations; only descriptors are
 * computed (reference: lvt_system::track_with_external_corners). */
LVT_API void lvt_track_with_external_corners(
    lvt_handle vo_system, unsigned char *left_img, unsigned char *right_img,
    int n_rows, int n_cols, double corners_left[][2], int n_corners_left,
    double corners_right[][2], int n_corners_right, double R[3][3],
    double t[3]);

/* 1 = not initialized yet, 2 = tracking, 3 = tracking lost. */
LVT_API int lvt_get_status(lvt_handle vo_system);

/* Beyond the reference ABI: reset the system (clear map + state machine),
 * the operation the reference only exposes through its ROS shell. */
LVT_API void lvt_reset(lvt_handle vo_system);

#ifdef __cplusplus
}
#endif

#endif /* LVT_TPU_C_INTERFACE_H */
