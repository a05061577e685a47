/* libsonata_tpu — C ABI for the sonata-tpu speech synthesizer.
 *
 * Counterpart of the reference's cbindgen-generated libsonata.h
 * (crates/frontends/capi): voice load/unload, audio info, Piper synthesis
 * config get/set, and callback-driven synthesis with blocking and
 * non-blocking modes.  The callback receives SPEECH / FINISHED / ERROR
 * events and may cancel by returning non-zero
 * (reference capi/src/lib.rs:101-153, 425-427).
 *
 * The library hosts (or joins) a CPython interpreter; `sonata_tpu` must be
 * importable (set PYTHONPATH accordingly).
 */

#ifndef LIBSONATA_TPU_H
#define LIBSONATA_TPU_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* error codes (0 = success; parity range with capi/src/lib.rs:19-26) */
enum SonataErrorCode {
  SONATA_OK = 0,
  SONATA_ERR_LOAD_FAILED = 16,
  SONATA_ERR_INVALID_HANDLE = 17,
  SONATA_ERR_SYNTHESIS_FAILED = 18,
  SONATA_ERR_INVALID_ARGUMENT = 19,
  SONATA_ERR_IO = 20,
  SONATA_ERR_CANCELLED = 21
};

enum SonataEventType {
  SONATA_EVENT_SPEECH = 0,
  SONATA_EVENT_FINISHED = 1,
  SONATA_EVENT_ERROR = 2
};

enum SonataSynthesisMode {
  SONATA_MODE_LAZY = 0,
  SONATA_MODE_BATCHED = 1,
  SONATA_MODE_REALTIME = 2
};

typedef struct SonataAudioInfo {
  uint32_t sample_rate;
  uint32_t num_channels;
  uint32_t sample_width; /* bytes per sample (2 = 16-bit PCM) */
} SonataAudioInfo;

typedef struct SonataPiperSynthConfig {
  float length_scale;
  float noise_scale;
  float noise_w;
  int64_t speaker_id; /* -1 = default speaker */
} SonataPiperSynthConfig;

/* One synthesis event.  For SPEECH events `data` points at `len` int16
 * samples, valid only for the duration of the callback. */
typedef struct SonataSynthesisEvent {
  int32_t event_type;       /* SonataEventType */
  const char *error;        /* non-NULL only for ERROR events */
  uint64_t len;             /* number of int16 samples */
  const int16_t *data;      /* sample data for SPEECH events */
} SonataSynthesisEvent;

/* Return non-zero to cancel synthesis. */
typedef int32_t (*SonataSpeechCallback)(const SonataSynthesisEvent *event,
                                        void *user_data);

typedef struct SonataSynthesisParams {
  int32_t mode;                  /* SonataSynthesisMode */
  uint8_t rate;                  /* 0-100; 255 = unset */
  uint8_t volume;                /* 0-100; 255 = unset */
  uint8_t pitch;                 /* 0-100; 255 = unset */
  uint32_t appended_silence_ms;  /* 0 = none */
  SonataSpeechCallback callback; /* required for libsonataSpeak */
  void *user_data;
  int32_t nonblocking;           /* 1: return immediately, events on a
                                    worker thread (capi lib.rs:374-382) */
} SonataSynthesisParams;

/* Load a voice; returns a handle > 0, or a negative SonataErrorCode.
 * On failure *error_out (if non-NULL) receives a malloc'd message the
 * caller frees with libsonataFreeString. */
int64_t libsonataLoadVoiceFromConfigPath(const char *config_path,
                                         char **error_out);

int32_t libsonataUnloadSonataVoice(int64_t voice);

int32_t libsonataGetAudioInfo(int64_t voice, SonataAudioInfo *out);

int32_t libsonataGetPiperDefaultSynthConfig(int64_t voice,
                                            SonataPiperSynthConfig *out);

int32_t libsonataSetPiperSynthConfig(int64_t voice,
                                     const SonataPiperSynthConfig *config);

/* Synthesize `text`, delivering events through params->callback. */
int32_t libsonataSpeak(int64_t voice, const char *text,
                       const SonataSynthesisParams *params);

/* Synthesize `text` into a 16-bit PCM WAV file (callback optional). */
int32_t libsonataSpeakToFile(int64_t voice, const char *text,
                             const char *wav_path,
                             const SonataSynthesisParams *params);

void libsonataFreeString(char *s);

const char *libsonataGetVersion(void);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* LIBSONATA_TPU_H */
