// Native host data-loader: multi-threaded WAV decode + chunk assembly.
//
// The port's copy of the JAX package's host loader
// (wespeaker_hubert_tpu/data/native/loader.cc), the counterpart of the
// reference's C++ IO layer (reference: runtime/core/frontend/wav.h RIFF
// parser, runtime/core/utils/blocking_queue.h producer/consumer,
// runtime/core/utils/thread_pool.h): a worker pool decodes PCM16/PCM32/
// float32 RIFF files, applies the training chunk policy (random crop or
// tile-pad, reference processor.py:291-323), and feeds fixed-shape
// float32 batches through a bounded queue so the host never stalls the
// device.  Exposed as a C ABI consumed via ctypes; the Python wrapper is
// data/native_loader.py, which builds this file at first use.
//
// One addition to the JAX package's loaders: Loader2 and Loader3 take the
// configured sample rate and refuse a wav whose header names another one
// (counted with its name and rate, loader{2,3}_rate_refusals; the wrapper
// raises).  The emission order is otherwise the JAX loaders' own.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread loader.cc -o libloader.so -lz
//        [-DWESP_HAVE_ZSTD -lzstd]

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <zlib.h>
#ifdef WESP_HAVE_ZSTD
#include <zstd.h>
#endif
#include <mutex>
#include <random>
#include <string>
#include <deque>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------- wav io
bool DecodeWavBytes(const std::vector<uint8_t>& buf, std::vector<float>* out,
                    int* sr_out = nullptr) {
  if (buf.size() < 44) return false;
  if (memcmp(buf.data(), "RIFF", 4) || memcmp(buf.data() + 8, "WAVE", 4))
    return false;

  size_t pos = 12;
  uint16_t audio_fmt = 0, nchan = 0, bits = 0;
  while (pos + 8 <= buf.size()) {
    const char* cid = reinterpret_cast<const char*>(buf.data() + pos);
    uint32_t csize;
    memcpy(&csize, buf.data() + pos + 4, 4);
    const uint8_t* body = buf.data() + pos + 8;
    if (pos + 8 + csize > buf.size()) csize = buf.size() - pos - 8;
    if (!memcmp(cid, "fmt ", 4) && csize >= 16) {
      memcpy(&audio_fmt, body, 2);
      memcpy(&nchan, body + 2, 2);
      memcpy(&bits, body + 14, 2);
      if (sr_out) {
        uint32_t sr;
        memcpy(&sr, body + 4, 4);
        *sr_out = static_cast<int>(sr);
      }
    } else if (!memcmp(cid, "data", 4) && audio_fmt) {
      size_t n = 0;
      std::vector<float> mono;
      if (audio_fmt == 1 && bits == 16) {
        n = csize / 2;
        const int16_t* d = reinterpret_cast<const int16_t*>(body);
        mono.resize(n);
        for (size_t i = 0; i < n; ++i) mono[i] = d[i] / 32768.0f;
      } else if (audio_fmt == 1 && bits == 32) {
        n = csize / 4;
        const int32_t* d = reinterpret_cast<const int32_t*>(body);
        mono.resize(n);
        for (size_t i = 0; i < n; ++i) mono[i] = d[i] / 2147483648.0f;
      } else if (audio_fmt == 3 && bits == 32) {
        n = csize / 4;
        const float* d = reinterpret_cast<const float*>(body);
        mono.assign(d, d + n);
      } else {
        return false;
      }
      if (nchan > 1) {
        size_t frames = mono.size() / nchan;
        out->resize(frames);
        for (size_t i = 0; i < frames; ++i) {
          float acc = 0;
          for (int c = 0; c < nchan; ++c) acc += mono[i * nchan + c];
          (*out)[i] = acc / nchan;
        }
      } else {
        *out = std::move(mono);
      }
      return true;
    }
    pos += 8 + csize + (csize & 1);
  }
  return false;
}

bool ReadWavMono(const std::string& path, std::vector<float>* out,
                 int* sr_out = nullptr) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 44) { fclose(f); return false; }
  std::vector<uint8_t> buf(size);
  if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return false;
  }
  fclose(f);
  return DecodeWavBytes(buf, out, sr_out);
}

// ------------------------------------------------------- rate refusals
// Wavs whose header rate differs from the configured one: a count, and
// the first one's name and rate for the wrapper's error.
struct RateRefusals {
  std::atomic<long> count{0};
  std::mutex mu;
  std::string name;
  int rate = 0;

  void Add(const std::string& what, int sr) {
    std::lock_guard<std::mutex> lock(mu);
    if (count.fetch_add(1) == 0) {
      name = what;
      rate = sr;
    }
  }

  long Get(char* name_out, int cap, int32_t* rate_out) {
    std::lock_guard<std::mutex> lock(mu);
    if (name_out && cap > 0) {
      size_t n = std::min(name.size(), static_cast<size_t>(cap - 1));
      memcpy(name_out, name.data(), n);
      name_out[n] = 0;
    }
    if (rate_out) *rate_out = rate;
    return count.load();
  }
};

// ------------------------------------------------------------ chunk policy
void RandomChunk(const std::vector<float>& wav, int chunk, std::mt19937* rng,
                 float* out) {
  const size_t n = wav.size();
  if (n == 0) {
    memset(out, 0, sizeof(float) * chunk);
    return;
  }
  if (n >= static_cast<size_t>(chunk)) {
    std::uniform_int_distribution<size_t> dist(0, n - chunk);
    size_t start = dist(*rng);
    memcpy(out, wav.data() + start, sizeof(float) * chunk);
  } else {
    // tile-pad (reference processor.py:316-322)
    size_t off = 0;
    while (off < static_cast<size_t>(chunk)) {
      size_t take = std::min(n, chunk - off);
      memcpy(out + off, wav.data(), sizeof(float) * take);
      off += take;
    }
  }
}

// ------------------------------------------------- deterministic loader v2
//
// Production train-feed path (bin/train dataloader_args.num_workers): a
// loader that emits samples in thread-completion order makes batch
// COMPOSITION depend on timing.  v2 adds a sequence-numbered reorder
// window (4 x batch_size samples): workers claim epoch positions, decode
// concurrently, and insert results keyed by position; the consumer emits strictly in position order.  Batches are
// therefore a pure function of (seed, epoch, rank, world) — identical for
// any thread count, which is what makes step-exact mid-epoch resume hold
// with a parallel host loader (the torch DataLoader gives the reference
// the same property via per-worker round-robin).
//
// Also handles the supervised-chunk policy details the python
// TrainPipeline applies: [min,max] sample filtering (reference
// processor.py filter), speed-perturb index draw + label-space expansion
// (reference processor.py:286), and over-long chunks sized for the
// device resampler.
struct Sample2 {
  std::vector<float> wav;
  int32_t label = 0;
  int32_t speed = 0;
  bool ok = false;
};

struct Loader2 {
  std::vector<std::string> paths;
  std::vector<int32_t> labels;  // base speaker ids
  int num_spks = 0;             // >0 enables speed perturb (x3 labels)
  int chunk_samples;
  int batch_size;
  int min_samples;
  int max_samples;
  unsigned seed;
  int num_threads;
  int rank = 0, world = 1;
  int sample_rate = 0;            // >0: refuse wavs at another rate
  size_t window;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_insert, cv_emit;
  std::vector<Sample2> ring;      // window-sized reorder buffer
  std::vector<bool> present;
  size_t next_emit = 0;           // consumer cursor (epoch position)
  std::atomic<size_t> next_claim{0};
  std::atomic<int> epoch{0};
  std::atomic<bool> stop{false};
  std::atomic<long> decode_failures{0};  // unparseable wavs (see loader2_failures)
  RateRefusals refusals;
  std::vector<size_t> order;      // this rank's epoch order

  void Shuffle() {
    std::vector<size_t> perm(paths.size());
    for (size_t i = 0; i < perm.size(); ++i) perm[i] = i;
    std::mt19937 rng(seed + 1000003u * epoch.load());
    std::shuffle(perm.begin(), perm.end(), rng);
    order.clear();
    for (size_t i = rank; i < perm.size(); i += world)
      order.push_back(perm[i]);
    next_claim = 0;
    next_emit = 0;
  }

  void Worker() {
    while (!stop.load()) {
      size_t pos = next_claim.fetch_add(1);
      if (pos >= order.size()) break;
      size_t id = order[pos];
      Sample2 s;
      s.label = labels[id];
      std::vector<float> wav;
      int sr = 0;
      bool decoded = ReadWavMono(paths[id], &wav, &sr);
      if (!decoded) ++decode_failures;  // format v1-reader can't parse
      bool rate_ok = !decoded || sample_rate <= 0 || sr == sample_rate;
      if (!rate_ok) refusals.Add(paths[id], sr);
      s.ok = decoded && rate_ok &&
             wav.size() >= static_cast<size_t>(min_samples) &&
             wav.size() <= static_cast<size_t>(max_samples);
      if (s.ok) {
        // per-(epoch, sample) RNG: chunk + speed draws are functions of
        // the sample identity, independent of worker/thread timing
        std::mt19937 rng(seed + 104729u * epoch.load() +
                         2654435761u * static_cast<unsigned>(id));
        if (num_spks > 0) {
          s.speed = static_cast<int32_t>(rng() % 3);
          s.label += static_cast<int32_t>(num_spks) * s.speed;
        }
        s.wav.resize(chunk_samples);
        RandomChunk(wav, chunk_samples, &rng, s.wav.data());
      }
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_insert.wait(lock, [this, pos] {
          return pos < next_emit + window || stop.load();
        });
        if (stop.load()) break;
        size_t slot = pos % window;
        ring[slot] = std::move(s);
        present[slot] = true;
      }
      cv_emit.notify_one();
    }
    cv_emit.notify_all();
  }

  void StartEpoch(int e) {
    JoinWorkers();
    epoch = e;
    Shuffle();
    ring.assign(window, Sample2{});
    present.assign(window, false);
    stop = false;
    workers.clear();
    for (int i = 0; i < num_threads; ++i)
      workers.emplace_back(&Loader2::Worker, this);
  }

  void JoinWorkers() {
    {
      std::lock_guard<std::mutex> lock(mu);  // see v1: lost-wakeup guard
      stop = true;
    }
    cv_insert.notify_all();
    cv_emit.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    stop = false;
  }

  // fills up to batch_size rows; returns rows filled (epoch ends on < batch)
  int NextBatch(float* wav_out, int32_t* label_out, int32_t* speed_out) {
    int filled = 0;
    while (filled < batch_size && next_emit < order.size()) {
      Sample2 s;
      {
        std::unique_lock<std::mutex> lock(mu);
        size_t slot = next_emit % window;
        cv_emit.wait(lock, [this, slot] {
          return present[slot] || stop.load();
        });
        if (stop.load() && !present[slot]) break;
        s = std::move(ring[slot]);
        present[slot] = false;
        ++next_emit;
      }
      cv_insert.notify_all();
      if (!s.ok) continue;
      memcpy(wav_out + static_cast<size_t>(filled) * chunk_samples,
             s.wav.data(), sizeof(float) * chunk_samples);
      label_out[filled] = s.label;
      if (speed_out) speed_out[filled] = s.speed;
      ++filled;
    }
    return filled;
  }
};

// --------------------------------------------------- shard (tar) loader v3
//
// The reference's primary training input is webdataset-style tar shards
// (KEY.wav + KEY.spk members, tools/make_shard_list.py).  Tars are
// sequential by nature, so parallelism here is ACROSS shards: each worker
// thread streams its `[worker::num_workers]` stripe of this rank's
// shard list, applies the same per-sample policy as Loader2 (filter,
// chunk, speed draw + label expansion) plus a bounded-buffer shuffle
// (reference processor.py:198), and assembles full batches; the consumer
// emits batches ROUND-ROBIN over workers.  Batch composition is a pure
// function of (seed, epoch, rank, world, num_workers) — deterministic
// for any thread timing, like the python PrefetchPipeline but off-GIL.
//
// POSIX/GNU tar, plain or GZIP-compressed (tools/make_shard_list.py can
// emit .tar.gz; zlib's gz* API reads both transparently, so compressed
// shards stream through the SAME worker pool instead of falling back to
// the slow python pipeline).  ZSTD shards stream through
// ZSTD_decompressStream when the .so was built against libzstd
// (-DWESP_HAVE_ZSTD, the default when the dev package is present —
// native_loader.py probes at build time); xz remains unsupported
// (decode_failures counts skipped shards).

struct TarEntry {
  std::string name;
  std::vector<uint8_t> data;
};

// streams regular-file entries from a (possibly gzip/zstd-compressed) tar
struct TarReader {
  gzFile f = nullptr;
#ifdef WESP_HAVE_ZSTD
  FILE* zfp = nullptr;
  ZSTD_DStream* zds = nullptr;
  std::vector<uint8_t> zibuf;
  ZSTD_inBuffer zin{nullptr, 0, 0};
#endif
  bool ok = false;

  explicit TarReader(const std::string& path) {
    // zlib handles plain + gzip; zstd (28 b5 2f fd) takes the
    // ZSTD_decompressStream path when compiled in; xz (fd 37) rejected
    FILE* probe = fopen(path.c_str(), "rb");
    if (!probe) return;
    uint8_t magic[2] = {0, 0};
    size_t got = fread(magic, 1, 2, probe);
    if (got == 2 && magic[0] == 0x28 && magic[1] == 0xb5) {
#ifdef WESP_HAVE_ZSTD
      rewind(probe);
      zds = ZSTD_createDStream();
      if (!zds) {
        fclose(probe);
        return;
      }
      zibuf.resize(ZSTD_DStreamInSize());
      zin = {zibuf.data(), 0, 0};
      zfp = probe;
      ok = true;
#else
      fclose(probe);
#endif
      return;
    }
    fclose(probe);
    if (got != 2 || (magic[0] == 0xfd && magic[1] == 0x37)) return;
    f = gzopen(path.c_str(), "rb");
    if (!f) return;
    // bigger inflate buffer: tar member payloads are ~100-500 KB wavs
    gzbuffer(f, 1 << 18);
    ok = true;
  }

  ~TarReader() {
    if (f) gzclose(f);
#ifdef WESP_HAVE_ZSTD
    if (zds) ZSTD_freeDStream(zds);
    if (zfp) fclose(zfp);
#endif
  }

#ifdef WESP_HAVE_ZSTD
  // pull exactly n decompressed bytes from the zstd stream; handles
  // multi-frame archives (a new frame simply continues from the next
  // input refill)
  bool ZstdRead(void* dst, size_t n) {
    ZSTD_outBuffer out{dst, n, 0};
    while (out.pos < out.size) {
      if (zin.pos == zin.size) {
        size_t r = fread(zibuf.data(), 1, zibuf.size(), zfp);
        if (r == 0) return false;  // output still owed but input exhausted
        zin = {zibuf.data(), r, 0};
      }
      size_t ret = ZSTD_decompressStream(zds, &out, &zin);
      if (ZSTD_isError(ret)) return false;
    }
    return true;
  }
#endif

  bool ReadFull(void* dst, size_t n) {
#ifdef WESP_HAVE_ZSTD
    if (zds) return ZstdRead(dst, n);
#endif
    return gzread(f, dst, static_cast<unsigned>(n)) ==
           static_cast<int>(n);
  }

  bool Skip(long n) {  // gzseek SEEK_CUR inflates through, works gz+plain
#ifdef WESP_HAVE_ZSTD
    if (zds) {  // no seek on a zstd stream: decompress-and-discard
      uint8_t scratch[4096];
      while (n > 0) {
        size_t take = n < static_cast<long>(sizeof(scratch))
                          ? static_cast<size_t>(n)
                          : sizeof(scratch);
        if (!ZstdRead(scratch, take)) return false;
        n -= static_cast<long>(take);
      }
      return true;
    }
#endif
    return n == 0 || gzseek(f, n, SEEK_CUR) >= 0;
  }

  bool Next(TarEntry* e) {
    if (!ok) return false;  // covers both the gz and zstd handles
    uint8_t hdr[512];
    std::string longname;
    while (true) {
      if (!ReadFull(hdr, 512)) return false;
      bool empty = true;
      for (int i = 0; i < 512; ++i)
        if (hdr[i]) { empty = false; break; }
      if (empty) return false;  // end-of-archive blocks
      char size_field[13];
      memcpy(size_field, hdr + 124, 12);
      size_field[12] = 0;
      long size = strtol(size_field, nullptr, 8);
      if (size < 0) return false;
      long padded = (size + 511) & ~511L;
      char type = static_cast<char>(hdr[156]);
      if (type == 'L') {  // GNU long name: payload is the next entry's name
        std::vector<char> nm(size + 1, 0);
        if (!ReadFull(nm.data(), size)) return false;
        if (!Skip(padded - size)) return false;
        longname.assign(nm.data());
        continue;
      }
      if (type != '0' && type != 0) {  // not a regular file: skip payload
        if (!Skip(padded)) return false;
        longname.clear();  // an 'L' name applies only to the NEXT entry
        continue;
      }
      std::string name;
      if (!longname.empty()) {
        name = longname;
      } else {
        char nm[101];
        memcpy(nm, hdr, 100);
        nm[100] = 0;
        char pre[156];
        memcpy(pre, hdr + 345, 155);
        pre[155] = 0;
        name = pre[0] ? std::string(pre) + "/" + nm : std::string(nm);
      }
      e->name = std::move(name);
      e->data.resize(size);
      if (size && !ReadFull(e->data.data(), size)) return false;
      if (!Skip(padded - size)) return false;
      return true;
    }
  }
};

struct Batch3 {
  std::vector<float> wav;
  std::vector<int32_t> label;
  std::vector<int32_t> speed;
};

struct Loader3 {
  std::vector<std::string> shards;
  std::unordered_map<std::string, int32_t> spk2id;
  int num_spks = 0;  // >0: speed perturb + x3 labels
  int chunk_samples;
  int batch_size;
  int min_samples;
  int max_samples;
  int shuffle_size;
  unsigned seed;
  int num_threads;
  int rank = 0, world = 1;
  int sample_rate = 0;  // >0: refuse wavs at another rate
  size_t queue_cap = 4;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::vector<std::deque<Batch3>> queues;   // one per worker
  std::vector<bool> done;
  std::atomic<int> epoch{0};
  std::atomic<bool> stop{false};
  std::atomic<long> decode_failures{0};
  RateRefusals refusals;
  size_t turn = 0;  // round-robin cursor over live workers

  void Worker(int w) {
    // this worker's shard stripe of this rank's epoch order
    std::vector<size_t> order(shards.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    std::mt19937 shard_rng(seed + 1000003u * epoch.load());
    std::shuffle(order.begin(), order.end(), shard_rng);
    std::vector<size_t> mine;
    for (size_t i = rank; i < order.size(); i += world)
      mine.push_back(order[i]);
    // worker stripe
    std::vector<size_t> stripe;
    for (size_t i = w; i < mine.size(); i += num_threads)
      stripe.push_back(mine[i]);

    std::mt19937 shuffle_rng(seed + 77u * epoch.load() + 7919u * w);
    struct Pending {
      std::vector<float> wav;
      int32_t label, speed;
    };
    std::vector<Pending> buf;
    Batch3 cur;
    cur.wav.reserve(static_cast<size_t>(batch_size) * chunk_samples);

    auto emit_sample = [&](Pending&& p) {
      cur.wav.insert(cur.wav.end(), p.wav.begin(), p.wav.end());
      cur.label.push_back(p.label);
      cur.speed.push_back(p.speed);
      if (static_cast<int>(cur.label.size()) == batch_size) {
        std::unique_lock<std::mutex> lock(mu);
        cv_push.wait(lock, [this, w] {
          return queues[w].size() < queue_cap || stop.load();
        });
        if (stop.load()) return false;
        queues[w].push_back(std::move(cur));
        lock.unlock();
        cv_pop.notify_all();
        cur = Batch3();
        cur.wav.reserve(static_cast<size_t>(batch_size) * chunk_samples);
      }
      return true;
    };

    auto push_shuffled = [&](Pending&& p) {
      // bounded-buffer streaming shuffle (reference processor.py:198)
      buf.push_back(std::move(p));
      if (static_cast<int>(buf.size()) >= shuffle_size) {
        size_t idx = std::uniform_int_distribution<size_t>(
            0, buf.size() - 1)(shuffle_rng);
        std::swap(buf[idx], buf.back());
        Pending out = std::move(buf.back());
        buf.pop_back();
        return emit_sample(std::move(out));
      }
      return true;
    };

    bool alive = true;
    for (size_t si : stripe) {
      if (!alive || stop.load()) break;
      TarReader tr(shards[si]);
      if (!tr.ok) {
        ++decode_failures;  // unreadable/compressed shard
        continue;
      }
      TarEntry e;
      std::string cur_key, cur_spk;
      std::vector<uint8_t> cur_wav;
      long sample_idx = 0;
      auto flush_group = [&]() {
        if (cur_key.empty() || cur_wav.empty()) return true;
        auto it = spk2id.find(cur_spk);
        if (it == spk2id.end()) return true;
        std::vector<float> wav;
        int sr = 0;
        if (!DecodeWavBytes(cur_wav, &wav, &sr)) {
          ++decode_failures;
          return true;
        }
        if (sample_rate > 0 && sr != sample_rate) {
          refusals.Add(cur_key, sr);
          return true;
        }
        if (wav.size() < static_cast<size_t>(min_samples) ||
            wav.size() > static_cast<size_t>(max_samples))
          return true;
        Pending p;
        p.label = it->second;
        p.speed = 0;
        std::mt19937 rng(seed + 104729u * epoch.load() +
                         2654435761u * static_cast<unsigned>(
                             std::hash<std::string>{}(cur_key) ^
                             static_cast<size_t>(si * 131 + sample_idx)));
        if (num_spks > 0) {
          p.speed = static_cast<int32_t>(rng() % 3);
          p.label += static_cast<int32_t>(num_spks) * p.speed;
        }
        p.wav.resize(chunk_samples);
        RandomChunk(wav, chunk_samples, &rng, p.wav.data());
        ++sample_idx;
        return push_shuffled(std::move(p));
      };
      while (alive && !stop.load() && tr.Next(&e)) {
        auto dot = e.name.rfind('.');
        if (dot == std::string::npos) continue;
        std::string base = e.name.substr(0, dot);
        std::string ext = e.name.substr(dot + 1);
        if (base != cur_key) {
          alive = flush_group();
          cur_key = base;
          cur_spk.clear();
          cur_wav.clear();
        }
        if (ext == "wav") {
          cur_wav = std::move(e.data);
        } else if (ext == "spk" || ext == "txt") {
          cur_spk.assign(e.data.begin(), e.data.end());
          while (!cur_spk.empty() &&
                 (cur_spk.back() == '\n' || cur_spk.back() == '\r' ||
                  cur_spk.back() == ' '))
            cur_spk.pop_back();
        }
      }
      if (alive) alive = flush_group();
    }
    // drain the shuffle buffer (reference: final buffer is shuffled whole)
    if (alive && !stop.load()) {
      std::shuffle(buf.begin(), buf.end(), shuffle_rng);
      for (auto& p : buf) {
        if (!emit_sample(std::move(p))) break;
      }
    }
    {
      std::lock_guard<std::mutex> lock(mu);
      done[w] = true;  // partial `cur` batch is dropped (training drop_last)
    }
    cv_pop.notify_all();
  }

  void StartEpoch(int e) {
    JoinWorkers();
    epoch = e;
    queues.assign(num_threads, {});
    done.assign(num_threads, false);
    turn = 0;
    stop = false;
    for (int i = 0; i < num_threads; ++i)
      workers.emplace_back(&Loader3::Worker, this, i);
  }

  void JoinWorkers() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    stop = false;
  }

  int NextBatch(float* wav_out, int32_t* label_out, int32_t* speed_out) {
    std::unique_lock<std::mutex> lock(mu);
    while (true) {
      // advance the round-robin turn past finished-and-empty workers
      int live = 0;
      for (int i = 0; i < num_threads; ++i)
        if (!done[i] || !queues[i].empty()) ++live;
      if (live == 0) return 0;
      size_t w = turn % num_threads;
      while (done[w] && queues[w].empty()) {
        turn = (turn + 1) % num_threads;
        w = turn % num_threads;
      }
      if (!queues[w].empty()) {
        Batch3 b = std::move(queues[w].front());
        queues[w].pop_front();
        turn = (turn + 1) % num_threads;
        lock.unlock();
        cv_push.notify_all();
        int n = static_cast<int>(b.label.size());
        memcpy(wav_out, b.wav.data(), sizeof(float) * b.wav.size());
        memcpy(label_out, b.label.data(), sizeof(int32_t) * n);
        if (speed_out)
          memcpy(speed_out, b.speed.data(), sizeof(int32_t) * n);
        return n;
      }
      cv_pop.wait(lock, [this, w] {
        return !queues[w].empty() || done[w] || stop.load();
      });
      if (stop.load()) return 0;
    }
  }
};

}  // namespace

extern "C" {

// capability probe for the python wrapper: 1 when this .so was compiled
// against libzstd (dataset.py routes .tar.zst shards accordingly)
int loader_zstd_supported(void) {
#ifdef WESP_HAVE_ZSTD
  return 1;
#else
  return 0;
#endif
}

void* loader2_create(const char** paths, const int32_t* labels, int n,
                     int num_spks, int chunk_samples, int batch_size,
                     int min_samples, int max_samples, unsigned seed,
                     int num_threads, int rank, int world,
                     int sample_rate) {
  auto* l = new Loader2();
  l->paths.assign(paths, paths + n);
  l->labels.assign(labels, labels + n);
  l->num_spks = num_spks;
  l->chunk_samples = chunk_samples;
  l->batch_size = batch_size;
  l->min_samples = min_samples;
  l->max_samples = max_samples > 0 ? max_samples : INT32_MAX;
  l->seed = seed;
  l->num_threads = num_threads > 0 ? num_threads : 4;
  l->window = 4 * batch_size;
  l->rank = rank;
  l->world = world > 0 ? world : 1;
  l->sample_rate = sample_rate;
  return l;
}

void loader2_start_epoch(void* h, int epoch) {
  static_cast<Loader2*>(h)->StartEpoch(epoch);
}

int loader2_next(void* h, float* wav_out, int32_t* label_out,
                 int32_t* speed_out) {
  return static_cast<Loader2*>(h)->NextBatch(wav_out, label_out, speed_out);
}

void loader2_destroy(void* h) {
  auto* l = static_cast<Loader2*>(h);
  l->JoinWorkers();
  delete l;
}

long loader2_failures(void* h) {
  return static_cast<Loader2*>(h)->decode_failures.load();
}

// wavs refused for their rate; the first one's path and rate
long loader2_rate_refusals(void* h, char* name_out, int cap, int32_t* rate_out) {
  return static_cast<Loader2*>(h)->refusals.Get(name_out, cap, rate_out);
}

void* loader3_create(const char** shards, int n_shards,
                     const char** spk_names, const int32_t* spk_ids,
                     int n_spks_map, int num_spks, int chunk_samples,
                     int batch_size, int min_samples, int max_samples,
                     int shuffle_size, unsigned seed, int num_threads,
                     int rank, int world, int sample_rate) {
  auto* l = new Loader3();
  l->shards.assign(shards, shards + n_shards);
  for (int i = 0; i < n_spks_map; ++i)
    l->spk2id.emplace(spk_names[i], spk_ids[i]);
  l->num_spks = num_spks;
  l->chunk_samples = chunk_samples;
  l->batch_size = batch_size;
  l->min_samples = min_samples;
  l->max_samples = max_samples > 0 ? max_samples : INT32_MAX;
  l->shuffle_size = shuffle_size > 1 ? shuffle_size : 2;
  l->seed = seed;
  l->num_threads = num_threads > 0 ? num_threads : 4;
  l->rank = rank;
  l->world = world > 0 ? world : 1;
  l->sample_rate = sample_rate;
  return l;
}

void loader3_start_epoch(void* h, int epoch) {
  static_cast<Loader3*>(h)->StartEpoch(epoch);
}

int loader3_next(void* h, float* wav_out, int32_t* label_out,
                 int32_t* speed_out) {
  return static_cast<Loader3*>(h)->NextBatch(wav_out, label_out, speed_out);
}

long loader3_failures(void* h) {
  return static_cast<Loader3*>(h)->decode_failures.load();
}

// wavs refused for their rate; the first one's key and rate
long loader3_rate_refusals(void* h, char* name_out, int cap, int32_t* rate_out) {
  return static_cast<Loader3*>(h)->refusals.Get(name_out, cap, rate_out);
}

void loader3_destroy(void* h) {
  auto* l = static_cast<Loader3*>(h);
  l->JoinWorkers();
  delete l;
}

}  // extern "C"
