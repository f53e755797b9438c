// In-memory ordered-log broker with a C ABI: topics × partitions, offset
// monotone append, consumer-group commits, keyed partitioning.
//
// A copy of fluidframework_tpu's native/src/oplog.cpp: the native engine
// behind fluidframework_tpu_torch.server.log — the moral equivalent of the
// reference's librdkafka dependency (a C++ Kafka client binding,
// server/routerlicious/packages/services/package.json:40) for the
// in-process broker the partition host consumes. The Python MessageLog in
// server/log.py has identical semantics (its LocalKafka role); it is
// chosen only by name (native=False), never as a fallback.
//
// Records are opaque byte strings; Python pickles payloads across the
// boundary the same way rdkafka ships serialized frames.

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Msg {
  std::string key;
  std::string val;
};

struct Partition {
  std::vector<Msg> msgs;
  mutable std::mutex mu;

  int64_t append(const char* k, size_t klen, const char* v, size_t vlen) {
    std::lock_guard<std::mutex> g(mu);
    msgs.push_back(Msg{std::string(k, klen), std::string(v, vlen)});
    return static_cast<int64_t>(msgs.size()) - 1;
  }

  int64_t end_offset() const {
    std::lock_guard<std::mutex> g(mu);
    return static_cast<int64_t>(msgs.size());
  }
};

struct Topic {
  std::vector<std::unique_ptr<Partition>> parts;
  explicit Topic(int n) {
    for (int i = 0; i < n; ++i) parts.emplace_back(new Partition);
  }
};

struct Log {
  std::unordered_map<std::string, std::unique_ptr<Topic>> topics;
  std::map<std::string, int64_t> commits;  // "group\0topic\0part" -> next
  std::mutex mu;
  int default_partitions = 1;
};

std::mutex g_mu;
std::unordered_map<int64_t, std::unique_ptr<Log>> g_logs;
int64_t g_next_handle = 1;

Log* get_log(int64_t h) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_logs.find(h);
  return it == g_logs.end() ? nullptr : it->second.get();
}

Topic* get_topic(Log* log, const char* name, int partitions) {
  std::lock_guard<std::mutex> g(log->mu);
  auto it = log->topics.find(name);
  if (it == log->topics.end()) {
    int n = partitions > 0 ? partitions : log->default_partitions;
    it = log->topics
             .emplace(std::string(name), std::unique_ptr<Topic>(new Topic(n)))
             .first;
  }
  return it->second.get();
}

// Stable keyed partitioning (FNV-1a), unlike Python's per-process str hash:
// a document's partition assignment survives restarts, which the per-doc
// checkpoint/resume path depends on.
uint64_t fnv1a(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= 1099511628211ull;
  }
  return h;
}

std::string commit_key(const char* group, const char* topic, int part) {
  std::string k(group);
  k.push_back('\0');
  k += topic;
  k.push_back('\0');
  k += std::to_string(part);
  return k;
}

}  // namespace

extern "C" {

int64_t oplog_create(int default_partitions) {
  std::lock_guard<std::mutex> g(g_mu);
  int64_t h = g_next_handle++;
  auto log = std::unique_ptr<Log>(new Log);
  log->default_partitions = default_partitions > 0 ? default_partitions : 1;
  g_logs.emplace(h, std::move(log));
  return h;
}

void oplog_destroy(int64_t h) {
  std::lock_guard<std::mutex> g(g_mu);
  g_logs.erase(h);
}

// Ensure the topic exists; returns its partition count (or -1 on bad handle).
int oplog_topic(int64_t h, const char* name, int partitions) {
  Log* log = get_log(h);
  if (!log) return -1;
  return static_cast<int>(get_topic(log, name, partitions)->parts.size());
}

int oplog_partition_for(int64_t h, const char* topic, const char* key,
                        size_t klen) {
  Log* log = get_log(h);
  if (!log) return -1;
  Topic* t = get_topic(log, topic, 0);
  return static_cast<int>(fnv1a(key, klen) % t->parts.size());
}

// partition < 0 routes by key hash. Returns the assigned offset, -1 on error.
int64_t oplog_append(int64_t h, const char* topic, int partition,
                     const char* key, size_t klen, const char* val,
                     size_t vlen) {
  Log* log = get_log(h);
  if (!log) return -1;
  Topic* t = get_topic(log, topic, 0);
  if (partition < 0)
    partition = static_cast<int>(fnv1a(key, klen) % t->parts.size());
  if (partition >= static_cast<int>(t->parts.size())) return -1;
  return t->parts[partition]->append(key, klen, val, vlen);
}

int64_t oplog_end_offset(int64_t h, const char* topic, int partition) {
  Log* log = get_log(h);
  if (!log) return -1;
  Topic* t = get_topic(log, topic, 0);
  if (partition < 0 || partition >= static_cast<int>(t->parts.size()))
    return -1;
  return t->parts[partition]->end_offset();
}

// Copy up to max_msgs whole records starting at `start` (or the group's
// committed offset when start < 0) into buf as frames:
//   u64 offset | u32 klen | u32 vlen | key bytes | val bytes
// Returns bytes written; *out_count = records copied. If the first record
// alone does not fit, returns -(bytes needed) so the caller can grow buf.
int64_t oplog_poll(int64_t h, const char* group, const char* topic,
                   int partition, int max_msgs, int64_t start, char* buf,
                   int64_t buflen, int64_t* out_count) {
  *out_count = 0;
  Log* log = get_log(h);
  if (!log) return -1;
  Topic* t = get_topic(log, topic, 0);
  if (partition < 0 || partition >= static_cast<int>(t->parts.size()))
    return -1;
  if (start < 0) {
    std::lock_guard<std::mutex> g(log->mu);
    auto it = log->commits.find(commit_key(group, topic, partition));
    start = it == log->commits.end() ? 0 : it->second;
  }
  Partition* p = t->parts[partition].get();
  std::lock_guard<std::mutex> g(p->mu);
  int64_t written = 0;
  for (int i = 0; i < max_msgs; ++i) {
    int64_t off = start + i;
    if (off >= static_cast<int64_t>(p->msgs.size())) break;
    const Msg& m = p->msgs[static_cast<size_t>(off)];
    int64_t need = 16 + static_cast<int64_t>(m.key.size() + m.val.size());
    if (written + need > buflen) {
      if (*out_count == 0) return -need;
      break;
    }
    char* dst = buf + written;
    uint64_t off_u = static_cast<uint64_t>(off);
    uint32_t kl = static_cast<uint32_t>(m.key.size());
    uint32_t vl = static_cast<uint32_t>(m.val.size());
    std::memcpy(dst, &off_u, 8);
    std::memcpy(dst + 8, &kl, 4);
    std::memcpy(dst + 12, &vl, 4);
    std::memcpy(dst + 16, m.key.data(), kl);
    std::memcpy(dst + 16 + kl, m.val.data(), vl);
    written += need;
    ++*out_count;
  }
  return written;
}

// Commit "processed through offset": the next poll starts at offset + 1.
// Commits never move backwards (replay safety).
void oplog_commit(int64_t h, const char* group, const char* topic,
                  int partition, int64_t offset) {
  Log* log = get_log(h);
  if (!log) return;
  std::lock_guard<std::mutex> g(log->mu);
  std::string k = commit_key(group, topic, partition);
  auto it = log->commits.find(k);
  if (it == log->commits.end() || offset + 1 > it->second)
    log->commits[k] = offset + 1;
}

int64_t oplog_committed(int64_t h, const char* group, const char* topic,
                        int partition) {
  Log* log = get_log(h);
  if (!log) return -1;
  std::lock_guard<std::mutex> g(log->mu);
  auto it = log->commits.find(commit_key(group, topic, partition));
  return it == log->commits.end() ? 0 : it->second;
}

}  // extern "C"
