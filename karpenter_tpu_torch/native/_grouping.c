/* Native hot loop for pod grouping (solver/encode.group_pods).
 *
 * The scheduling tick's first host stage walks every pending pod and
 * buckets it into an equivalence class.  In pure Python that loop costs
 * ~1.5 us/pod on a fresh heap and 3-4x that on a churned steady-state
 * heap (50k dead pod objects from the previous tick scatter the
 * allocator); at 50k pods it was the largest host term left in the
 * scheduling-latency budget.  This extension runs the per-pod walk in C:
 * one attribute read (_spec_token, the shared-spec identity token
 * computed at Pod construction), one dict probe keyed by that token, and
 * one list append.  Signature misses -- once per distinct template --
 * call back into the Python `classify` closure, which keeps ALL
 * structural/canonical-key logic (and its correctness guarantees) in
 * encode.group_pods.
 *
 * The reference implements its equivalent grouping inside the Go
 * scheduler (pod scheduling requirements pre-grouping, karpenter core;
 * see designs/bin-packing.md "Pods are grouped by their scheduling
 * requirements").  Here the control plane is Python, so the native
 * surface is this CPython extension plus the JAX/XLA solver itself.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

static PyObject *str_spec_token = NULL;  /* interned "_spec_token" */
static PyObject *str_pods = NULL;        /* interned "pods" */

/* group_by_token(pods, classify) -> None
 *
 * For each pod:
 *   tok = pod._spec_token
 *   if tok is not None:
 *       lst = cache.get(tok)
 *       if lst is None:
 *           lst = classify(pod).pods       # Python slow path, once/template
 *           cache[tok] = lst
 *       lst.append(pod)
 *   else:
 *       classify(pod).pods.append(pod)     # spread pods: per-signature path
 *
 * `classify` must return an object with a list-valued `pods` attribute
 * (encode.PodClass) and is responsible for class registration/dedup.
 */
static PyObject *
group_by_token(PyObject *self, PyObject *args)
{
    PyObject *pods_obj, *classify;
    if (!PyArg_ParseTuple(args, "OO:group_by_token", &pods_obj, &classify))
        return NULL;

    PyObject *seq = PySequence_Fast(pods_obj, "group_by_token: pods must be a sequence");
    if (seq == NULL)
        return NULL;

    /* tok -> pods list (we hold our own reference via the dict) */
    PyObject *cache = PyDict_New();
    if (cache == NULL) {
        Py_DECREF(seq);
        return NULL;
    }

    /* size and item are re-read EVERY iteration: classify() and attribute
     * access run arbitrary Python, and if any of it mutates the pods list
     * a hoisted items pointer would dangle after a realloc. GET_ITEM on
     * the PySequence_Fast result is an index into the current ob_item
     * array, so re-reading keeps the walk safe (and caps it at the
     * current size). */
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(seq); i++) {
        /* own a reference for the whole iteration: a callback that removes
         * the pod from the list must not free it under us */
        PyObject *pod = PySequence_Fast_GET_ITEM(seq, i); /* borrowed */
        Py_INCREF(pod);
        PyObject *tok = PyObject_GetAttr(pod, str_spec_token);
        if (tok == NULL) {
            Py_DECREF(pod);
            goto fail;
        }

        PyObject *lst;
        if (tok == Py_None) {
            /* spread pods carry no token: per-pod Python signature path */
            Py_DECREF(tok);
            PyObject *pc = PyObject_CallOneArg(classify, pod);
            if (pc == NULL) {
                Py_DECREF(pod);
                goto fail;
            }
            lst = PyObject_GetAttr(pc, str_pods);
            Py_DECREF(pc);
            if (lst == NULL) {
                Py_DECREF(pod);
                goto fail;
            }
            int rc = PyList_Append(lst, pod);
            Py_DECREF(lst);
            Py_DECREF(pod);
            if (rc < 0)
                goto fail;
            continue;
        }

        lst = PyDict_GetItemWithError(cache, tok); /* borrowed */
        if (lst == NULL) {
            if (PyErr_Occurred()) {
                Py_DECREF(tok);
                Py_DECREF(pod);
                goto fail;
            }
            PyObject *pc = PyObject_CallOneArg(classify, pod);
            if (pc == NULL) {
                Py_DECREF(tok);
                Py_DECREF(pod);
                goto fail;
            }
            lst = PyObject_GetAttr(pc, str_pods);
            Py_DECREF(pc);
            if (lst == NULL || !PyList_Check(lst)) {
                Py_XDECREF(lst);
                Py_DECREF(tok);
                Py_DECREF(pod);
                PyErr_SetString(PyExc_TypeError,
                                "group_by_token: classify(pod).pods must be a list");
                goto fail;
            }
            int rc = PyDict_SetItem(cache, tok, lst);
            Py_DECREF(lst); /* dict holds it; keep borrowed below */
            if (rc < 0) {
                Py_DECREF(tok);
                Py_DECREF(pod);
                goto fail;
            }
            lst = PyDict_GetItemWithError(cache, tok); /* borrowed again */
            if (lst == NULL) {
                Py_DECREF(tok);
                Py_DECREF(pod);
                goto fail;
            }
        }
        Py_DECREF(tok);
        int rc = PyList_Append(lst, pod);
        Py_DECREF(pod);
        if (rc < 0)
            goto fail;
    }

    Py_DECREF(cache);
    Py_DECREF(seq);
    Py_RETURN_NONE;

fail:
    Py_DECREF(cache);
    Py_DECREF(seq);
    return NULL;
}

static PyMethodDef Methods[] = {
    {"group_by_token", group_by_token, METH_VARARGS,
     "Bucket pods into classes by shared-spec token; classify() handles misses."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_grouping",
    "Native pod-grouping hot loop for karpenter_tpu.solver.encode",
    -1, Methods,
};

PyMODINIT_FUNC
PyInit__grouping(void)
{
    str_spec_token = PyUnicode_InternFromString("_spec_token");
    str_pods = PyUnicode_InternFromString("pods");
    if (str_spec_token == NULL || str_pods == NULL)
        return NULL;
    return PyModule_Create(&moduledef);
}
