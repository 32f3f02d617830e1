/* C ABI shared library around lvt_tpu_torch (liblvt_c_torch.so).
 *
 * Equivalent of the reference's lvt_c.cpp (lvt/src/lvt_c.cpp:33-148), which
 * wraps lvt_system behind an extern "C" surface, and a copy of lvt_tpu's
 * native/lvt_c.cpp: the same C surface (lvt_c.h) over the PyTorch pipeline.
 * The library embeds a CPython interpreter and forwards every call to
 * lvt_tpu_torch.capi (which wraps the raw buffers as numpy views without
 * copying and drives VOSystem on the device LVT_TPU_TORCH_DEVICE names,
 * default cuda).
 *
 * Error contract matches the reference: all exceptions are swallowed,
 * lvt_create returns NULL on failure, and failed tracks leave R/t at the
 * identity (lvt_c.cpp catches ... and returns nothing).
 *
 * Threading: any thread may call in; each entry point takes the GIL via
 * PyGILState_Ensure. The interpreter is initialized once on first
 * lvt_create and intentionally never finalized (CUDA contexts and torch's
 * state do not survive re-initialization).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

#include "lvt_c.h"

namespace {

PyObject *g_capi = nullptr; /* lvt_tpu_torch.capi module, owned */
std::mutex g_init_mutex;

/* Initialize the embedded interpreter. Honors LVT_PYTHON / VIRTUAL_ENV so
 * the venv's site-packages (torch, numpy) resolve exactly as they do for the
 * venv's own binary. Returns true when the interpreter + capi module are
 * ready. */
bool ensure_python() {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_capi != nullptr) {
    return true;
  }
  if (!Py_IsInitialized()) {
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    const char *py = std::getenv("LVT_PYTHON");
    std::string program;
    if (py != nullptr) {
      program = py;
    } else if (const char *venv = std::getenv("VIRTUAL_ENV")) {
      program = std::string(venv) + "/bin/python3";
    }
    if (!program.empty()) {
      /* program_name drives CPython's pyvenv.cfg discovery, which points
       * sys.prefix at the venv. */
      PyConfig_SetBytesString(&config, &config.program_name, program.c_str());
    }
    PyStatus status = Py_InitializeFromConfig(&config);
    PyConfig_Clear(&config);
    if (PyStatus_Exception(status)) {
      return false;
    }
    /* Release the GIL acquired by initialization so PyGILState_Ensure
     * works uniformly from every caller thread below. */
    PyEval_SaveThread();
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *mod = PyImport_ImportModule("lvt_tpu_torch.capi");
  if (mod == nullptr) {
    PyErr_Print();
  } else {
    g_capi = mod;
  }
  PyGILState_Release(gil);
  return g_capi != nullptr;
}

/* Copy a 12-float (row-major R then t) result tuple into R/t. Leaves the
 * outputs untouched on any error. */
void unpack_pose(PyObject *result, double R[3][3], double t[3]) {
  if (result == nullptr || !PySequence_Check(result) ||
      PySequence_Size(result) != 12) {
    return;
  }
  double vals[12];
  for (Py_ssize_t i = 0; i < 12; ++i) {
    PyObject *item = PySequence_GetItem(result, i);
    vals[i] = PyFloat_AsDouble(item);
    Py_XDECREF(item);
    if (PyErr_Occurred()) {
      PyErr_Clear();
      return;
    }
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      R[i][j] = vals[3 * i + j];
    }
  }
  t[0] = vals[9];
  t[1] = vals[10];
  t[2] = vals[11];
}

void set_identity(double R[3][3], double t[3]) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      R[i][j] = (i == j) ? 1.0 : 0.0;
    }
    t[i] = 0.0;
  }
}

} // namespace

extern "C" {

LVT_API lvt_handle lvt_create(const char *config_file_name, int sensor_type) {
  if (config_file_name == nullptr || !ensure_python()) {
    return nullptr;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *res = PyObject_CallMethod(g_capi, "create", "si",
                                      config_file_name, sensor_type);
  long handle = 0;
  if (res != nullptr) {
    handle = PyLong_AsLong(res);
    Py_DECREF(res);
  }
  if (PyErr_Occurred()) {
    PyErr_Print();
    handle = 0;
  }
  PyGILState_Release(gil);
  /* handle ids start at 1, so (void*)handle is never NULL for a live
   * system — same opaque-pointer contract as the reference. */
  return reinterpret_cast<lvt_handle>(static_cast<intptr_t>(handle));
}

LVT_API void lvt_destroy(lvt_handle vo_system) {
  if (vo_system == nullptr || g_capi == nullptr) {
    return;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *res = PyObject_CallMethod(
      g_capi, "destroy", "l",
      static_cast<long>(reinterpret_cast<intptr_t>(vo_system)));
  Py_XDECREF(res);
  PyErr_Clear();
  PyGILState_Release(gil);
}

LVT_API void lvt_track(lvt_handle vo_system, unsigned char *left_img,
                       unsigned char *right_img, int n_rows, int n_cols,
                       double R[3][3], double t[3]) {
  set_identity(R, t);
  if (vo_system == nullptr || g_capi == nullptr) {
    return;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  const Py_ssize_t n = static_cast<Py_ssize_t>(n_rows) * n_cols;
  PyObject *ml = PyMemoryView_FromMemory(reinterpret_cast<char *>(left_img),
                                         n, PyBUF_READ);
  PyObject *mr = PyMemoryView_FromMemory(reinterpret_cast<char *>(right_img),
                                         n, PyBUF_READ);
  PyObject *res = nullptr;
  if (ml != nullptr && mr != nullptr) {
    res = PyObject_CallMethod(
        g_capi, "track", "lOOii",
        static_cast<long>(reinterpret_cast<intptr_t>(vo_system)), ml, mr,
        n_rows, n_cols);
  }
  unpack_pose(res, R, t);
  if (PyErr_Occurred()) {
    PyErr_Print();
  }
  Py_XDECREF(res);
  Py_XDECREF(ml);
  Py_XDECREF(mr);
  PyGILState_Release(gil);
}

LVT_API void lvt_track_with_external_corners(
    lvt_handle vo_system, unsigned char *left_img, unsigned char *right_img,
    int n_rows, int n_cols, double corners_left[][2], int n_corners_left,
    double corners_right[][2], int n_corners_right, double R[3][3],
    double t[3]) {
  set_identity(R, t);
  if (vo_system == nullptr || g_capi == nullptr) {
    return;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  const Py_ssize_t n = static_cast<Py_ssize_t>(n_rows) * n_cols;
  PyObject *ml = PyMemoryView_FromMemory(reinterpret_cast<char *>(left_img),
                                         n, PyBUF_READ);
  PyObject *mr = PyMemoryView_FromMemory(reinterpret_cast<char *>(right_img),
                                         n, PyBUF_READ);
  PyObject *cl = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(corners_left),
      static_cast<Py_ssize_t>(n_corners_left) * 2 * sizeof(double),
      PyBUF_READ);
  PyObject *cr = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(corners_right),
      static_cast<Py_ssize_t>(n_corners_right) * 2 * sizeof(double),
      PyBUF_READ);
  PyObject *res = nullptr;
  if (ml != nullptr && mr != nullptr && cl != nullptr && cr != nullptr) {
    res = PyObject_CallMethod(
        g_capi, "track_with_external_corners", "lOOiiOiOi",
        static_cast<long>(reinterpret_cast<intptr_t>(vo_system)), ml, mr,
        n_rows, n_cols, cl, n_corners_left, cr, n_corners_right);
  }
  unpack_pose(res, R, t);
  if (PyErr_Occurred()) {
    PyErr_Print();
  }
  Py_XDECREF(res);
  Py_XDECREF(ml);
  Py_XDECREF(mr);
  Py_XDECREF(cl);
  Py_XDECREF(cr);
  PyGILState_Release(gil);
}

LVT_API int lvt_get_status(lvt_handle vo_system) {
  if (vo_system == nullptr || g_capi == nullptr) {
    return 0;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *res = PyObject_CallMethod(
      g_capi, "get_status", "l",
      static_cast<long>(reinterpret_cast<intptr_t>(vo_system)));
  int status = 0;
  if (res != nullptr) {
    status = static_cast<int>(PyLong_AsLong(res));
    Py_DECREF(res);
  }
  PyErr_Clear();
  PyGILState_Release(gil);
  return status;
}

LVT_API void lvt_reset(lvt_handle vo_system) {
  if (vo_system == nullptr || g_capi == nullptr) {
    return;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *res = PyObject_CallMethod(
      g_capi, "reset", "l",
      static_cast<long>(reinterpret_cast<intptr_t>(vo_system)));
  Py_XDECREF(res);
  PyErr_Clear();
  PyGILState_Release(gil);
}

} // extern "C"
