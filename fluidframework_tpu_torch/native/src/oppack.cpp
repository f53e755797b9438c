// Native op packer: per-document HostOp streams -> packed int32 columns.
//
// The lane stores pack every serving window's ops (mergetree/oppack.py
// pack_ops): a window of 100k ops is ~1M Python ints. This walks the
// object graph once with the CPython C API (HostOp is a NamedTuple, i.e.
// a tuple: PyTuple_GET_ITEM + PyLong_AsLong per field) and writes straight
// into a caller-owned [n_fields, B, T] int32 buffer.
//
// Loaded with ctypes.PyDLL (the GIL is held throughout: we touch Python
// objects). Returns 0 on success; d+1 when document d overflows t steps;
// a negative code when the input is not what pack_ops takes, which the
// caller raises as an error (there is no second packer):
//   -1  streams, or one stream, is not a sequence        (TypeError)
//   -2  streams holds another count than b               (TypeError)
//   -3  an op is not a tuple of nf fields                (TypeError)
//   -4  a field is not an integer                        (TypeError)
//   -5  a field lies outside int32 (no silent wrap: a wrapped value
//       could alias a sentinel)                          (OverflowError)
// On a negative code, *where receives the failing document and op index
// (d * 2^32 + i) so the caller can name the op.

#include <Python.h>

#include <cstdint>

extern "C" long pack_into(PyObject* streams, int32_t* dst, long b, long t,
                          long nf, long long* where) {
    PyObject* fast_streams =
        PySequence_Fast(streams, "streams must be a sequence");
    if (fast_streams == nullptr) {
        PyErr_Clear();
        return -1;
    }
    if (PySequence_Fast_GET_SIZE(fast_streams) != b) {
        Py_DECREF(fast_streams);
        return -2;
    }
    long rc = 0;
    for (long d = 0; d < b && rc == 0; ++d) {
        PyObject* stream = PySequence_Fast_GET_ITEM(fast_streams, d);
        PyObject* fs = PySequence_Fast(stream, "stream must be a sequence");
        if (fs == nullptr) {
            PyErr_Clear();
            *where = static_cast<long long>(d) << 32;
            rc = -1;
            break;
        }
        const long n = PySequence_Fast_GET_SIZE(fs);
        if (n > t) {
            Py_DECREF(fs);
            rc = d + 1;  // overflow report: which document
            break;
        }
        for (long i = 0; i < n && rc == 0; ++i) {
            PyObject* op = PySequence_Fast_GET_ITEM(fs, i);
            if (!PyTuple_Check(op) || PyTuple_GET_SIZE(op) != nf) {
                rc = -3;
            }
            for (long f = 0; f < nf && rc == 0; ++f) {
                const long v = PyLong_AsLong(PyTuple_GET_ITEM(op, f));
                if (v == -1 && PyErr_Occurred()) {
                    const bool big =
                        PyErr_ExceptionMatches(PyExc_OverflowError);
                    PyErr_Clear();
                    rc = big ? -5 : -4;
                } else if (v < INT32_MIN || v > INT32_MAX) {
                    rc = -5;
                } else {
                    dst[(f * b + d) * t + i] = static_cast<int32_t>(v);
                }
            }
            if (rc != 0) {
                *where = (static_cast<long long>(d) << 32) | i;
            }
        }
        Py_DECREF(fs);
    }
    Py_DECREF(fast_streams);
    return rc;
}
