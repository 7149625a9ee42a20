/* CPython extension: the warm-path pod-grouping walk.
 *
 * canonical_pod_groups (models/encoding.py) walks every pending pod per
 * solve reading the pod's cached (epoch, sig-id) pair and bucketing pods
 * by sig id in arrival order. As bytecode that walk is the largest host
 * layer of a 50k-pod solve, while the work per pod is six C-API calls.
 * This module does exactly that walk at C speed. (A copy of the
 * reference repository's native/groupwalk.c; built by native/_build.py.)
 *
 * Contract (mirrors the python loop it replaces, encoding.py):
 *   walk(pods, epoch) -> (by_sid: dict[int, list], misses: list | None)
 * - pods: sequence of objects whose __dict__ may cache "_sig_id" as an
 *   (epoch, sid) tuple of ints.
 * - For every pod whose cache entry is present and current, append the
 *   pod to by_sid[sid] preserving arrival order.
 * - On the FIRST pod with a missing/stale entry, return (None, misses)
 *   where misses lists every pod lacking a current entry — the caller
 *   interns them (the slow path that computes signatures) and calls
 *   again. One retry suffices: interning is idempotent and the second
 *   pass sees every entry warm.
 *
 * The caller holds the GIL throughout (no threads released): dict/list
 * mutations here follow the exact single-threaded semantics of the
 * python loop.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

static PyObject *sig_id_key; /* interned "_sig_id" */

static PyObject *
walk(PyObject *self, PyObject *args)
{
    PyObject *pods;
    long long epoch;
    if (!PyArg_ParseTuple(args, "OL", &pods, &epoch))
        return NULL;
    PyObject *seq = PySequence_Fast(pods, "pods must be a sequence");
    if (seq == NULL)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject **items = PySequence_Fast_ITEMS(seq);

    PyObject *by_sid = PyDict_New();
    if (by_sid == NULL) {
        Py_DECREF(seq);
        return NULL;
    }
    PyObject *misses = NULL;   /* created lazily on first stale entry */
    long long prev_sid = -1;
    PyObject *bucket = NULL;   /* borrowed ref (owned by by_sid) */

    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *pod = items[i];
        PyObject **dictptr = _PyObject_GetDictPtr(pod);
        PyObject *ent = NULL;
        if (dictptr != NULL && *dictptr != NULL)
            ent = PyDict_GetItemWithError(*dictptr, sig_id_key); /* borrowed */
        if (ent == NULL && PyErr_Occurred())
            goto fail;
        long long sid = -1;
        if (ent != NULL && PyTuple_CheckExact(ent)
                && PyTuple_GET_SIZE(ent) == 2) {
            long long e = PyLong_AsLongLong(PyTuple_GET_ITEM(ent, 0));
            if (e == -1 && PyErr_Occurred())
                goto fail;
            if (e == epoch) {
                sid = PyLong_AsLongLong(PyTuple_GET_ITEM(ent, 1));
                if (sid == -1 && PyErr_Occurred())
                    goto fail;
            }
        }
        if (sid < 0) {
            /* stale or missing: collect this and every later stale pod */
            if (misses == NULL) {
                misses = PyList_New(0);
                if (misses == NULL)
                    goto fail;
            }
            if (PyList_Append(misses, pod) < 0)
                goto fail;
            continue;
        }
        if (misses != NULL)
            continue; /* grouping is void this pass; only collect misses */
        if (sid != prev_sid) {
            prev_sid = sid;
            PyObject *key = PyTuple_GET_ITEM(ent, 1); /* borrowed PyLong */
            bucket = PyDict_GetItemWithError(by_sid, key);
            if (bucket == NULL) {
                if (PyErr_Occurred())
                    goto fail;
                bucket = PyList_New(0);
                if (bucket == NULL)
                    goto fail;
                int rc = PyDict_SetItem(by_sid, key, bucket);
                Py_DECREF(bucket); /* by_sid holds the ref now */
                if (rc < 0)
                    goto fail;
            }
        }
        if (PyList_Append(bucket, pod) < 0)
            goto fail;
    }
    Py_DECREF(seq);
    if (misses != NULL) {
        Py_DECREF(by_sid);
        PyObject *out = Py_BuildValue("(ON)", Py_None, misses);
        return out;
    }
    PyObject *out = Py_BuildValue("(NO)", by_sid, Py_None);
    return out;

fail:
    Py_DECREF(seq);
    Py_DECREF(by_sid);
    Py_XDECREF(misses);
    return NULL;
}

static PyMethodDef methods[] = {
    {"walk", walk, METH_VARARGS,
     "walk(pods, epoch) -> (by_sid | None, misses | None)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "karpgroupwalk",
    "C-speed pod grouping walk", -1, methods,
};

PyMODINIT_FUNC
PyInit_karpgroupwalk(void)
{
    sig_id_key = PyUnicode_InternFromString("_sig_id");
    if (sig_id_key == NULL)
        return NULL;
    return PyModule_Create(&moduledef);
}
