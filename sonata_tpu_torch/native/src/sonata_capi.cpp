// libsonata_tpu: C ABI over the sonata-tpu Python framework.
//
// Counterpart of the reference's Rust cdylib (crates/frontends/capi): this
// shim hosts (or joins) a CPython interpreter and marshals between the C
// surface declared in include/libsonata_tpu.h and the Python bridge module
// sonata_tpu_torch.frontends.capi_bridge.  Synthesis is callback-driven with
// SPEECH/FINISHED/ERROR events, cancellation via non-zero callback returns,
// and an optional non-blocking mode that runs the event loop on a detached
// worker thread (reference capi/src/lib.rs:374-382).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>

#include "../include/libsonata_tpu.h"

namespace {

constexpr const char *kBridgeModule = "sonata_tpu_torch.frontends.capi_bridge";

// Ensure an interpreter exists and return a GIL guard.  When the library is
// loaded inside an existing CPython process (e.g. via ctypes) we join it;
// standalone C programs get their own interpreter.
class GIL {
 public:
  GIL() {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // release the GIL acquired by initialization so PyGILState works
      // from any thread afterwards
      (void)PyEval_SaveThread();
    }
    state_ = PyGILState_Ensure();
  }
  ~GIL() { PyGILState_Release(state_); }
  GIL(const GIL &) = delete;
  GIL &operator=(const GIL &) = delete;

 private:
  PyGILState_STATE state_;
};

std::string fetch_py_error() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  PyErr_NormalizeException(&type, &value, &trace);
  std::string msg = "unknown python error";
  if (value != nullptr) {
    PyObject *s = PyObject_Str(value);
    if (s != nullptr) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  return msg;
}

PyObject *bridge() {  // borrowed-new reference to the bridge module
  return PyImport_ImportModule(kBridgeModule);
}

char *dup_string(const std::string &s) {
  char *out = static_cast<char *>(std::malloc(s.size() + 1));
  if (out != nullptr) std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

int32_t emit_error(const SonataSynthesisParams *params,
                   const std::string &msg) {
  if (params != nullptr && params->callback != nullptr) {
    SonataSynthesisEvent ev{};
    ev.event_type = SONATA_EVENT_ERROR;
    ev.error = msg.c_str();
    params->callback(&ev, params->user_data);
  }
  return SONATA_ERR_SYNTHESIS_FAILED;
}

// Runs the speech generator to completion, firing callbacks.
int32_t run_speech(int64_t voice, const std::string &text,
                   SonataSynthesisParams params) {
  GIL gil;
  PyObject *mod = bridge();
  if (mod == nullptr) return emit_error(&params, fetch_py_error());
  PyObject *gen = PyObject_CallMethod(
      mod, "speak", "LsiiiiI", static_cast<long long>(voice), text.c_str(),
      static_cast<int>(params.mode), static_cast<int>(params.rate),
      static_cast<int>(params.volume), static_cast<int>(params.pitch),
      static_cast<unsigned int>(params.appended_silence_ms));
  Py_DECREF(mod);
  if (gen == nullptr) return emit_error(&params, fetch_py_error());

  int32_t rc = SONATA_OK;
  PyObject *item = nullptr;
  PyObject *iter = PyObject_GetIter(gen);
  Py_DECREF(gen);
  if (iter == nullptr) return emit_error(&params, fetch_py_error());
  while ((item = PyIter_Next(iter)) != nullptr) {
    char *buf = nullptr;
    Py_ssize_t n = 0;
    if (PyBytes_AsStringAndSize(item, &buf, &n) != 0) {
      Py_DECREF(item);
      rc = emit_error(&params, fetch_py_error());
      break;
    }
    SonataSynthesisEvent ev{};
    ev.event_type = SONATA_EVENT_SPEECH;
    ev.len = static_cast<uint64_t>(n / 2);
    ev.data = reinterpret_cast<const int16_t *>(buf);
    int32_t cancel = 0;
    if (params.callback != nullptr) {
      // callbacks may run for a while (e.g. writing to a sink); drop the
      // GIL so python-side producers keep working
      Py_BEGIN_ALLOW_THREADS
      cancel = params.callback(&ev, params.user_data);
      Py_END_ALLOW_THREADS
    }
    Py_DECREF(item);
    if (cancel != 0) {  // non-zero return cancels (capi lib.rs:425-427)
      rc = SONATA_ERR_CANCELLED;
      break;
    }
  }
  if (rc == SONATA_OK && PyErr_Occurred() != nullptr) {
    rc = emit_error(&params, fetch_py_error());
  }
  Py_DECREF(iter);
  if (rc == SONATA_OK && params.callback != nullptr) {
    SonataSynthesisEvent ev{};
    ev.event_type = SONATA_EVENT_FINISHED;
    params.callback(&ev, params.user_data);
  }
  return rc;
}

}  // namespace

extern "C" {

int64_t libsonataLoadVoiceFromConfigPath(const char *config_path,
                                         char **error_out) {
  if (config_path == nullptr) return -SONATA_ERR_INVALID_ARGUMENT;
  GIL gil;
  PyObject *mod = bridge();
  if (mod == nullptr) {
    if (error_out != nullptr) *error_out = dup_string(fetch_py_error());
    return -SONATA_ERR_LOAD_FAILED;
  }
  PyObject *res = PyObject_CallMethod(mod, "load_voice", "s", config_path);
  Py_DECREF(mod);
  if (res == nullptr) {
    if (error_out != nullptr) *error_out = dup_string(fetch_py_error());
    return -SONATA_ERR_LOAD_FAILED;
  }
  long long handle = PyLong_AsLongLong(res);
  Py_DECREF(res);
  if (handle <= 0) {
    if (error_out != nullptr) *error_out = dup_string("invalid handle");
    return -SONATA_ERR_LOAD_FAILED;
  }
  return static_cast<int64_t>(handle);
}

int32_t libsonataUnloadSonataVoice(int64_t voice) {
  GIL gil;
  PyObject *mod = bridge();
  if (mod == nullptr) return SONATA_ERR_INVALID_HANDLE;
  PyObject *res = PyObject_CallMethod(mod, "unload_voice", "L",
                                      static_cast<long long>(voice));
  Py_DECREF(mod);
  if (res == nullptr) {
    PyErr_Clear();
    return SONATA_ERR_INVALID_HANDLE;
  }
  Py_DECREF(res);
  return SONATA_OK;
}

int32_t libsonataGetAudioInfo(int64_t voice, SonataAudioInfo *out) {
  if (out == nullptr) return SONATA_ERR_INVALID_ARGUMENT;
  GIL gil;
  PyObject *mod = bridge();
  if (mod == nullptr) return SONATA_ERR_INVALID_HANDLE;
  PyObject *res = PyObject_CallMethod(mod, "audio_info", "L",
                                      static_cast<long long>(voice));
  Py_DECREF(mod);
  if (res == nullptr) {
    PyErr_Clear();
    return SONATA_ERR_INVALID_HANDLE;
  }
  unsigned int sr = 0, ch = 0, width = 0;
  if (!PyArg_ParseTuple(res, "III", &sr, &ch, &width)) {
    Py_DECREF(res);
    PyErr_Clear();
    return SONATA_ERR_SYNTHESIS_FAILED;
  }
  Py_DECREF(res);
  out->sample_rate = sr;
  out->num_channels = ch;
  out->sample_width = width;
  return SONATA_OK;
}

int32_t libsonataGetPiperDefaultSynthConfig(int64_t voice,
                                            SonataPiperSynthConfig *out) {
  if (out == nullptr) return SONATA_ERR_INVALID_ARGUMENT;
  GIL gil;
  PyObject *mod = bridge();
  if (mod == nullptr) return SONATA_ERR_INVALID_HANDLE;
  PyObject *res = PyObject_CallMethod(mod, "get_synth_config", "L",
                                      static_cast<long long>(voice));
  Py_DECREF(mod);
  if (res == nullptr) {
    PyErr_Clear();
    return SONATA_ERR_INVALID_HANDLE;
  }
  double ls = 0, ns = 0, nw = 0;
  long long sid = -1;
  if (!PyArg_ParseTuple(res, "dddL", &ls, &ns, &nw, &sid)) {
    Py_DECREF(res);
    PyErr_Clear();
    return SONATA_ERR_SYNTHESIS_FAILED;
  }
  Py_DECREF(res);
  out->length_scale = static_cast<float>(ls);
  out->noise_scale = static_cast<float>(ns);
  out->noise_w = static_cast<float>(nw);
  out->speaker_id = sid;
  return SONATA_OK;
}

int32_t libsonataSetPiperSynthConfig(int64_t voice,
                                     const SonataPiperSynthConfig *config) {
  if (config == nullptr) return SONATA_ERR_INVALID_ARGUMENT;
  GIL gil;
  PyObject *mod = bridge();
  if (mod == nullptr) return SONATA_ERR_INVALID_HANDLE;
  PyObject *res = PyObject_CallMethod(
      mod, "set_synth_config", "LfffL", static_cast<long long>(voice),
      config->length_scale, config->noise_scale, config->noise_w,
      static_cast<long long>(config->speaker_id));
  Py_DECREF(mod);
  if (res == nullptr) {
    PyErr_Clear();
    return SONATA_ERR_INVALID_HANDLE;
  }
  Py_DECREF(res);
  return SONATA_OK;
}

int32_t libsonataSpeak(int64_t voice, const char *text,
                       const SonataSynthesisParams *params) {
  if (text == nullptr || params == nullptr || params->callback == nullptr)
    return SONATA_ERR_INVALID_ARGUMENT;
  if (params->nonblocking != 0) {
    // detach a worker; events arrive on that thread
    // (reference submits to its shared rayon pool, capi lib.rs:374-382)
    std::thread(run_speech, voice, std::string(text), *params).detach();
    return SONATA_OK;
  }
  return run_speech(voice, text, *params);
}

int32_t libsonataSpeakToFile(int64_t voice, const char *text,
                             const char *wav_path,
                             const SonataSynthesisParams *params) {
  if (text == nullptr || wav_path == nullptr)
    return SONATA_ERR_INVALID_ARGUMENT;
  GIL gil;
  PyObject *mod = bridge();
  if (mod == nullptr) return SONATA_ERR_INVALID_HANDLE;
  SonataSynthesisParams defaults{};
  defaults.rate = 255;
  defaults.volume = 255;
  defaults.pitch = 255;
  const SonataSynthesisParams *p = params != nullptr ? params : &defaults;
  PyObject *res = PyObject_CallMethod(
      mod, "speak_to_file", "LssiiiiI", static_cast<long long>(voice), text,
      wav_path, static_cast<int>(p->mode), static_cast<int>(p->rate),
      static_cast<int>(p->volume), static_cast<int>(p->pitch),
      static_cast<unsigned int>(p->appended_silence_ms));
  Py_DECREF(mod);
  if (res == nullptr) {
    PyErr_Clear();
    return SONATA_ERR_SYNTHESIS_FAILED;
  }
  Py_DECREF(res);
  return SONATA_OK;
}

void libsonataFreeString(char *s) { std::free(s); }

const char *libsonataGetVersion(void) {
  static std::string version;
  GIL gil;
  PyObject *mod = bridge();
  if (mod != nullptr) {
    PyObject *res = PyObject_CallMethod(mod, "version", nullptr);
    Py_DECREF(mod);
    if (res != nullptr) {
      const char *c = PyUnicode_AsUTF8(res);
      if (c != nullptr) version = c;
      Py_DECREF(res);
    } else {
      PyErr_Clear();
    }
  } else {
    PyErr_Clear();
  }
  return version.c_str();
}

}  // extern "C"
